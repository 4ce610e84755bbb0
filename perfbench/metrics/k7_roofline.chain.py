"""k7_roofline.chain: K7's share of its roofline in the traced pass, %: the
least time of the serving forward of every hidden layer after the first
over the cohort's candidate windows (the reference's count:
``chain_costs.k7_forward_least_ms``) over the device time of K7's
kernels by name (``csrc/dense.cu``: ``dense_kernel``,
``dense_*_kernel``). The count assumes what the program does today, a
window scored once a carrier (K3's and K7's rows are the compacted
candidates of every haplotype); a program that scores fewer rows (each
distinct window once) would read over 100% here, so this reader is to be
pointed at the rows launched before such a change (the program counts
launches, not rows). Nothing when no K7 kernel ran or the head has no
such layer."""
from perfbench.lib.chain_costs import k7_forward_least_ms

PATTERN = r"\bdense_\w*kernel\b"


def read(ctx):
    trace, c = ctx["trace"], ctx["counters"]
    if trace is None or not c.get("candidate_windows"):
        return None
    ns, launches = trace.kernel_ns(PATTERN)
    least = k7_forward_least_ms(ctx["config"], c["candidate_windows"])
    if not launches or not least:
        return None
    return 100.0 * least / (ns * 1e-6)
