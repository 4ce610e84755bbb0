"""device_idle_pct.chain: the share of the traced pass in which no
operation ran on the card, %. The pass includes the host's parse, compile
and pack, so most of it is idle by design."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
