"""trainer_warmup_s: the seconds of the captured step's warm-up in the
run (the tracer's ``v2p.train.warmup`` span in ``train.CapturedStep``:
CAPTURE_WARMUP steps on a side stream, their first kernel calls, and the
kernels' first load with them), host clock. Nothing where the program
keeps no such span."""
SPAN = "v2p.train.warmup"


def read(ctx):
    try:
        from vcf2prot_tpu_torch.utils.timers import TRACER
    except ImportError:  # a program without its tracer
        return None
    found = [TRACER.spans(SPAN, traced) for traced in (False, True)]
    if not any(count for count, _total, _most in found):
        return None
    return sum(total for _count, total, _most in found)
