"""One traced stretch of a run: ``torch.profiler`` over a callable, its
events kept as plain tuples, and the reductions the per-layer readers
share (device busy time, kernel times by name, the span of each CUDA
graph replay on the device, the idle gaps by what the host was doing).

The profiler records no device activity in the first tens of
microseconds after it starts, so :func:`traced` runs spin kernels and
waits for them before the traced stretch, which a host annotation named
:data:`WINDOW` marks; every reduction keeps to that annotation.
"""
from __future__ import annotations

import bisect
import heapq
import re
from typing import NamedTuple

# the benchmark's host annotations begin so
ANNOTATION = "perfbench."
WINDOW = ANNOTATION + "traced"
SPIN_KERNELS, SPIN_CYCLES = 32, 50_000
GRAPH_LAUNCH = "cudaGraphLaunch"


class Event(NamedTuple):
    name: str
    start: int  # ns
    end: int  # ns
    corr: int


def _event(e) -> Event:
    start = int(e.start_ns())
    return Event(e.name(), start, start + int(e.duration_ns()),
                 int(e.correlation_id()))


class Trace:
    """The device's and the host's events of one traced stretch."""

    def __init__(self, device: list, host: list):
        self.host = sorted(host, key=lambda e: e.start)
        marks = [e for e in self.host if e.name == WINDOW]
        if not marks:
            raise RuntimeError(f"the trace has no {WINDOW} annotation")
        self.start, self.end = marks[0].start, marks[0].end
        self.device = sorted((e for e in device
                              if e.end > self.start and e.start < self.end),
                             key=lambda e: e.start)

    @classmethod
    def of(cls, prof) -> "Trace":
        """The events of a ``torch.profiler.profile`` that has ended."""
        import torch

        device, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            (device if e.device_type() == cuda else host).append(_event(e))
        # a host annotation's mirror on the device's timeline is no device
        # operation
        marks = {e.name for e in host if e.name.startswith(ANNOTATION)}
        return cls([e for e in device if e.name not in marks], host)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    def busy(self) -> list:
        """The union of the device's activity inside the window, as sorted
        disjoint ``(start, end)`` ns intervals."""
        out = []
        for e in self.device:
            s, t = max(e.start, self.start), min(e.end, self.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) * 1e-9

    def kernel_ns(self, pattern: str) -> tuple:
        """``(total ns, launches)`` of the device events whose names match
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        hits = [e.end - e.start for e in self.device if rx.search(e.name)]
        return sum(hits), len(hits)

    def replay_spans_ns(self) -> list:
        """The device span of each CUDA graph replay launched in the
        window (first start to last end of the work it launched), matched
        by the launch's CUPTI correlation id."""
        by_corr = {}
        for e in self.device:
            s, t = by_corr.get(e.corr, (e.start, e.end))
            by_corr[e.corr] = (min(s, e.start), max(t, e.end))
        spans = []
        for e in self.host:
            if e.name == GRAPH_LAUNCH and self.start <= e.start < self.end:
                hit = by_corr.get(e.corr)
                if hit:
                    spans.append(hit[1] - hit[0])
        return spans

    def mean_replay_ms(self):
        """The mean of :meth:`replay_spans_ns`, ms; None without any."""
        spans = self.replay_spans_ns()
        return sum(spans) / len(spans) * 1e-6 if spans else None

    def top_device_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the device operations that took the
        most time in the window, summed by name."""
        total = {}
        for e in self.device:
            total[e.name] = total.get(e.name, 0) + (e.end - e.start)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """``[[what the host was doing, seconds], ...]``: the window's
        stretches with no device activity, each named by the innermost
        host event that covers its middle (the window itself when none
        does), summed by name, the longest first."""
        gaps, at = [], self.start
        for s, t in self.busy():
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if self.end > at:
            gaps.append((at, self.end))
        starts = [e.start for e in self.host]
        live, i, total = [], 0, {}
        for s, t in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (s + t) // 2
            j = bisect.bisect_right(starts, mid)
            for e in self.host[i:j]:
                heapq.heappush(live, (-e.start, e.end, e.name))
            i = max(i, j)
            while live and live[0][1] < mid:
                heapq.heappop(live)
            name = live[0][2] if live else WINDOW
            total[name] = total.get(name, 0) + (t - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]


def traced(fn, device) -> tuple:
    """``(fn's result, Trace)``: ``fn()`` run under ``torch.profiler``
    inside the :data:`WINDOW` annotation, after spin kernels on a CUDA
    ``device``, and waited for."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(SPIN_KERNELS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        with record_function(WINDOW):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    return out, Trace.of(prof)
