"""k4_roofline: K4's share of its roofline in the traced fit, %: the least
time of the first layer's gradient over a batch (``scorer_grad_bytes``,
``scorer_ops``) times the steps traced, over the device time of K4's
kernels by name (``csrc/scorer_grad.cu``: ``window_layer1_grad_*``).
Nothing when no K4 kernel ran."""
from perfbench.lib.costs import head_widths, scorer_grad_ms

PATTERN = r"\bwindow_layer1_grad_\w*kernel\b"


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    ns, launches = trace.kernel_ns(PATTERN)
    if not launches:
        return None
    cfg = ctx["config"]
    least = scorer_grad_ms(ctx["counters"]["batch"], int(cfg["k"]),
                           head_widths(cfg)[0])
    return 100.0 * least * ctx["counters"]["traced_steps"] / (ns * 1e-6)
