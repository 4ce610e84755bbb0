"""k7_roofline: K7's share of its roofline in the traced fit, %: the
least time of every hidden layer after the first, both ways (the sum of
the bounds of its forward, input-gradient and weight-gradient kernels),
times the steps traced, over the device time of K7's kernels by name
(``csrc/dense.cu``: ``dense_kernel``, ``dense_*_kernel``,
``dense_weight_reduce_kernel``). Nothing when no K7 kernel ran."""
from perfbench.lib.costs import dense_layer_ms, head_widths

PATTERN = r"\bdense_\w*kernel\b"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    ns, launches = trace.kernel_ns(PATTERN)
    widths = head_widths(ctx["config"])[:-1]
    rows = ctx["counters"]["batch"]
    least = sum(dense_layer_ms(rows, a, b) for a, b in zip(widths,
                                                           widths[1:]))
    if not launches or not least:
        return None
    return 100.0 * least * ctx["counters"]["traced_steps"] / (ns * 1e-6)
