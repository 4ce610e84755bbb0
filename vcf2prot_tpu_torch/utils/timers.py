"""Stage timers and the profiler hook of the port.

``StageTimer`` is the counterpart of ``vcf2prot_tpu/utils/timers.py``'s:
the reference's only profiling is chrono timestamps printed at stage
boundaries under ``-v`` (reference: src/main.rs:17-60); this gives the same
verbose timeline plus accumulated per-stage durations.

``--profile DIR`` traces the execute stage with ``torch.profiler`` (host
activity, plus CUDA kernels and copies when a CUDA device is present) and
writes a Chrome trace to ``DIR/trace.json`` (:func:`torch_trace`).
"""
from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime, timezone


class StageTimer:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.durations: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.verbose:
            print(f"{name}, starting time is: {datetime.now(timezone.utc)}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.durations[name] = self.durations.get(name, 0.0) + dt
            if self.verbose:
                print(
                    f"{name}, finished at: {datetime.now(timezone.utc)} "
                    f"({dt:.3f}s)"
                )


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
