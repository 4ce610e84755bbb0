"""chain_stage_s: the mean seconds of a pass's neoantigen stage
(``PipelineResult.durations["Neoantigen scoring (device-resident)"]``:
pack, K1, the mask, the compaction, K3, K7, the ``[H, 1]`` product, the
rank, the fetch and the TSVs' writes), host clock, over the window's
untraced passes (the traced one where there is none)."""


def read(ctx):
    c = ctx["counters"]
    passes = c.get("passes") or ()
    passes = [p for p in passes if not p["traced"]] or passes
    found = [p["stages"][c["stage"]] for p in passes
             if c["stage"] in p["stages"]]
    return sum(found) / len(found) if found else None
