"""chain_plan_ms: the mean host milliseconds of a chunk's plan (the span
``v2p.chain.plan``: ``pack_cohort`` and its checks), over the window's
untraced passes (the traced one where there is none). Nothing where the
program keeps no such span."""
SPAN = "v2p.chain.plan"


def read(ctx):
    spans = ctx["counters"].get("spans", {})
    for traced in (0, 1):
        count, total = spans.get(f"{SPAN}|{traced}", (0, 0.0))
        if count:
            return 1e3 * total / count
    return None
