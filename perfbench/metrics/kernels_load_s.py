"""kernels_load_s: the seconds of the program's first load of its
kernels' library in the run (the tracer's ``v2p.kernels.load`` span: the
nvcc build included when it ran, else the library's load and its entry
points' declarations), host clock. Nothing where the program keeps no
such span."""
SPAN = "v2p.kernels.load"


def read(ctx):
    try:
        from vcf2prot_tpu_torch.utils.timers import TRACER
    except ImportError:  # a program without its tracer
        return None
    found = [TRACER.spans(SPAN, traced) for traced in (False, True)]
    if not any(count for count, _total, _most in found):
        return None
    return sum(total for _count, total, _most in found)
