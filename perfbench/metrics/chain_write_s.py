"""chain_write_s: the host seconds a pass spends writing its TSVs (the
spans ``v2p.chain.write``, one a chunk, summed), the mean over the
window's untraced passes (the traced one where there is none). Nothing
where the program keeps no such span."""
SPAN = "v2p.chain.write"


def read(ctx):
    c = ctx["counters"]
    spans = c.get("spans", {})
    for traced in (0, 1):
        count, total = spans.get(f"{SPAN}|{traced}", (0, 0.0))
        passes = sum(p["traced"] == bool(traced)
                     for p in c.get("passes", ()))
        if count and passes:
            return total / passes
    return None
