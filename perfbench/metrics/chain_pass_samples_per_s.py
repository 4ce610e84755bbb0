"""chain_pass_samples_per_s: the samples of the window's whole untraced
passes (every sample's ranked TSV written) over those passes' wall (host
clock, from ``run_pipeline``'s call to its return). A per-layer reading:
where the host's system calls slow by the minute, as on the H100 host of
PERF.md §2, runs of fixed work spread by 9-31% a set, wider than any
bound the benchmark may set."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("samples") or not c.get("wall_s"):
        return None
    return c["samples"] / c["wall_s"]
