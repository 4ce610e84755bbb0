"""memory_peak_gb: the device memory the run held at its peak, in GB
(1e9 bytes): the CUDA caching allocator's peak of allocated bytes over
set-up and the window (``torch.cuda.max_memory_allocated``), read by the
benchmark once the window has closed and before the reference runs; the
``memory_peak_bytes`` of the run's line. Nothing on a run without a
card."""


def read(ctx):
    peak = ctx.get("memory_peak_bytes")
    if not peak:
        return None
    return peak / 1e9
