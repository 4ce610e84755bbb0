"""fit_step_mfu_pct: the whole training step's share of the card's peak,
%: the least time of the work any correct step needs, from the
configuration's shapes alone (``perfbench.lib.costs.step_least_ms``: no
activation between layers counted), over the measured step
(``fit_step_ms``'s device span of a replay)."""
from perfbench.lib.costs import step_least_ms


def read(ctx):
    trace = ctx["trace"]
    step_ms = trace.mean_replay_ms() if trace is not None else None
    if step_ms is None:
        return None
    return 100.0 * step_least_ms(ctx["config"], ctx["counters"]["batch"]) \
        / step_ms
