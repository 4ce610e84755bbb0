"""chain_mfu_pct: the whole pass's share of the card's peak, %: the least
time of the scoring that any correct pass needs, each distinct 9-mer of
the cohort's candidates scored once (a window's score depends on its
residues alone; the reference's count, ``chain_costs.pass_least_ms``, from
the configuration's shapes alone, no activation between layers counted),
over the traced pass's length (the profiler's window, host parse and pack
included). It bounds ``k3_roofline.chain`` and ``k7_roofline.chain``: a
kernel taken off the path, or a pass that scores each distinct window
once, leaves this a true share."""
from perfbench.lib.chain_costs import pass_least_ms


def read(ctx):
    trace, c = ctx["trace"], ctx["counters"]
    if trace is None or not trace.device or not c.get("distinct_windows"):
        return None
    least = pass_least_ms(ctx["config"], c["distinct_windows"])
    return 100.0 * least / (trace.window_s * 1e3)
