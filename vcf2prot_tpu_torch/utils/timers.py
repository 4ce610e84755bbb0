"""Profiler hook of the port: ``--profile DIR`` traces the execute stage
with ``torch.profiler`` (host activity, plus CUDA kernels and copies when a
CUDA device is present) and writes a Chrome trace to ``DIR/trace.json``.
The stage timer itself is the host tier's ``vcf2prot_tpu.utils.timers``.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def torch_trace(logdir: str = None):
    """Optional torch.profiler trace around a block (no-op when logdir is
    empty)."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
