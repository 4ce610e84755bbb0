"""chain_kernel_ms: the milliseconds in which an operation ran on the card
during the traced pass (the union of its device operations, device
trace). Nothing without a trace that holds device operations."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.device:
        return None
    return 1e3 * trace.busy_s
