"""device_idle_pct.fit: the share of the traced fit in which no operation
ran on the card, %."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
