"""chain_device_chunk_pct: the share of chunks the card ran, %: the spans
``v2p.chain.launch`` over the spans ``v2p.chain.plan``, x 100, over the
window's untraced passes (the traced one where there is none). A chunk
that the card does not run (a non-contiguous or int64 pack, annotations
that do not tile) takes the host chain, ``_host_chunk_rows``, and opens no
launch. Nothing where the program keeps no such spans."""


def read(ctx):
    spans = ctx["counters"].get("spans", {})
    for traced in (0, 1):
        plans = spans.get(f"v2p.chain.plan|{traced}", (0, 0.0))[0]
        if plans:
            launches = spans.get(f"v2p.chain.launch|{traced}", (0, 0.0))[0]
            return 100.0 * launches / plans
    return None
