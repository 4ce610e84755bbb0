"""chain_prologue_s: the mean seconds a pass spends before the neoantigen
stage (the sum of ``PipelineResult.durations`` of every other stage, the
spans ``v2p.stage.*``: reading the proteome, the native parse and
compile), host clock, over the window's untraced passes (the traced one
where there is none)."""


def read(ctx):
    c = ctx["counters"]
    passes = c.get("passes")
    passes = [p for p in passes or () if not p["traced"]] or passes
    if not passes:
        return None
    return sum(sum(v for k, v in p["stages"].items() if k != c["stage"])
               for p in passes) / len(passes)
