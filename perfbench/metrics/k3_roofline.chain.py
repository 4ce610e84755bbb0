"""k3_roofline.chain: K3's share of its roofline in the traced pass, %: the
least time of the first layer over the cohort's candidate windows (the
reference's count, every carrier's: ``chain_costs.k3_least_ms``) over
the device time of K3's kernels by name (``csrc/scorer.cu``:
``window_layer1_kernel``). The count assumes what the program does
today, a window scored once a carrier (K3's and K7's rows are the
compacted candidates of every haplotype); a program that scores fewer
rows (each distinct window once) would read over 100% here, so this
reader is to be pointed at the rows launched before such a change (the
program counts launches, not rows). Nothing when no K3 kernel ran."""
from perfbench.lib.chain_costs import k3_least_ms

PATTERN = r"\bwindow_layer1_kernel\b"


def read(ctx):
    trace, c = ctx["trace"], ctx["counters"]
    if trace is None or not c.get("candidate_windows"):
        return None
    ns, launches = trace.kernel_ns(PATTERN)
    if not launches:
        return None
    least = k3_least_ms(ctx["config"], c["candidate_windows"])
    return 100.0 * least / (ns * 1e-6)
