"""trainer_capture_s: the seconds of the captured step's capture in the
run (the tracer's ``v2p.train.capture`` span in ``train.CapturedStep``:
the wait for the warm-up's work, the graph's capture and the state set
back), host clock. Nothing where the program keeps no such span."""
SPAN = "v2p.train.capture"


def read(ctx):
    try:
        from vcf2prot_tpu_torch.utils.timers import TRACER
    except ImportError:  # a program without its tracer
        return None
    found = [TRACER.spans(SPAN, traced) for traced in (False, True)]
    if not any(count for count, _total, _most in found):
        return None
    return sum(total for _count, total, _most in found)
