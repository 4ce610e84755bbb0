"""fit_step_ms: the mean device span of a training step's replay (its
first kernel's start to its last kernel's end, matched to its CUDA graph
launch) over the traced fit, ms."""


def read(ctx):
    trace = ctx["trace"]
    return trace.mean_replay_ms() if trace is not None else None
