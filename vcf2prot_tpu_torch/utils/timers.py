"""The port's tracer, its stage timers and its profiler hook.

One tracer a process, :data:`TRACER`, keeps what the program marks in its
own code, whether or not a profiler runs:

* **spans** (:meth:`Tracer.span`), opened at coarse points only (a fit's
  set-up, each epoch's gather, the weights' fetch, a chain chunk's
  stages, the pipeline's stages), never once a training step. Each closes
  into a ring of raw records of bounded length (name, host start and end
  by ``perf_counter_ns``, the enclosing span's name, whether a profiler
  recorded) and into per-name aggregates (count, total, max), kept apart
  for time while a ``torch.profiler`` records and time while none does.
  While a profiler records, a span is also a host event of its trace, on
  the profiler's clock, so the trace's idle gaps are named by the
  program's stage. The event is a record function of function scope:
  ``torch.profiler.record_function``'s user scope would be mirrored onto
  the device's timeline, where it reads as device work.
* **counters** (:meth:`Tracer.counter`): a count and host nanoseconds
  that their owner adds to in place on a hot path (a captured step's
  replay), with no call into torch. The tracer takes what they gained at
  its next span boundary, under the profiler state it saw at the one
  before.
* **device marks** (:meth:`Tracer.mark`): CUDA events with timing, at
  epoch boundaries only, in a ring a device that reuses its events; a
  mark that repeats the latest one's name records nothing, so a fit
  records two (its first gather, its fetch). :meth:`Tracer.device_spans`
  gives the device-clock span from a first mark to a last one (a fit's
  first gather to its fetch). None on the CPU.

``StageTimer`` is the counterpart of ``vcf2prot_tpu/utils/timers.py``'s:
the reference's only profiling is chrono timestamps printed at stage
boundaries under ``-v`` (reference: src/main.rs:17-60); this gives the same
verbose timeline plus accumulated per-stage durations, each stage a span
``v2p.stage.<name>``.

``--profile DIR`` traces the execute stage with ``torch.profiler`` (host
activity, the spans among it, plus CUDA kernels and copies when a CUDA
device is present) and writes a Chrome trace to ``DIR/trace.json``
(:func:`torch_trace`).
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from datetime import datetime, timezone

# raw span records kept, and device marks kept a device
RING = 4096
MARKS = 512
STAGE = "v2p.stage."


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process (never before
    torch is imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def _host_event(name: str):
    """A host event ``name`` in the recording profiler's trace, as a
    context manager; None where this torch has no function-scope record
    function."""
    fast = getattr(sys.modules["torch"]._C._profiler, "_RecordFunctionFast",
                   None)
    return None if fast is None else fast(name)


class Span:
    """One span: ``name``, the enclosing span's name ``parent`` (None at
    the top), host ``start`` and ``end`` (``perf_counter_ns``; ``end`` 0
    while open) and ``traced``, whether a profiler recorded when it
    opened."""

    __slots__ = ("name", "parent", "start", "end", "traced")

    def __init__(self, name: str, parent, traced: bool):
        self.name, self.parent, self.traced = name, parent, traced
        self.start = self.end = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


class Counter:
    """A count ``n`` and host nanoseconds ``ns`` that the owner adds to in
    place; ``taken_*``: what the tracer has taken of them."""

    __slots__ = ("n", "ns", "taken_n", "taken_ns")

    def __init__(self):
        self.n = self.ns = self.taken_n = self.taken_ns = 0


def pair_marks(marks, first: str, last: str) -> list:
    """``[(start, end), ...]`` of ``marks``, ``(name, traced, payload)``
    oldest first: for each mark named ``last`` that follows another one,
    the payloads of the first ``first`` mark after that one and of it
    (a fit: its first gather and its fetch). A stretch with a mark made
    while a profiler recorded, or with none named ``first``, gives
    nothing, nor does the stretch before the first ``last`` mark (cut by
    the ring)."""
    out, start, clean, seen = [], None, True, False
    for name, traced, payload in marks:
        if name == first and seen:
            start = payload if start is None else start
            clean = clean and not traced
        elif name == last:
            if start is not None and clean and not traced:
                out.append((start, payload))
            start, clean, seen = None, True, True
    return out


class _MarkRing:
    """The marks of one device: CUDA events with timing, all made with the
    ring (recorded once on ``stream``, as torch makes an event at its first
    record) and then reused, oldest overwritten. A mark of the latest
    mark's name and profiler state records nothing: :func:`pair_marks`
    reads only the first of such a run (a fit's first gather), and an
    event in the stream between two graph replays costs the card time."""

    def __init__(self, size: int, stream):
        import torch

        self.events = [torch.cuda.Event(enable_timing=True)
                       for _ in range(size)]
        for event in self.events:
            event.record(stream)
        self.names = [None] * size
        self.traced = [False] * size
        self.at = 0  # marks recorded

    def repeats(self, name: str, traced: bool) -> bool:
        """Whether the latest mark has this name and profiler state."""
        i = (self.at - 1) % len(self.events)
        return self.at > 0 and (self.names[i], self.traced[i]) == (
            name, traced)

    def record(self, name: str, traced: bool, stream) -> None:
        i = self.at % len(self.events)
        self.events[i].record(stream)
        self.names[i], self.traced[i] = name, traced
        self.at += 1

    def oldest_first(self) -> list:
        n = len(self.events)
        slots = range(self.at - n, self.at) if self.at > n else range(self.at)
        return [(self.names[i % n], self.traced[i % n], self.events[i % n])
                for i in slots]


class Tracer:
    """Spans, counters and device marks of one process (module
    docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._counters = {}
        self.clear()

    def clear(self) -> None:
        """Forget every record, aggregate and mark; counters handed out
        stay live and count from zero."""
        with self._lock:
            self.records = collections.deque(maxlen=RING)
            # [untraced, traced]: name -> [count, total ns, max ns]
            self._spans = ({}, {})
            # [untraced, traced]: name -> [count, ns]
            self._counts = ({}, {})
            for c in self._counters.values():
                c.n = c.ns = c.taken_n = c.taken_ns = 0
            self._traced = False
            self._marks = {}

    # recording

    def _settle(self) -> bool:
        """Take what the counters gained since the last boundary, under
        the profiler state seen there; returns the state now."""
        now = profiling()
        with self._lock:
            side = self._counts[self._traced]
            for name, c in self._counters.items():
                n, ns = c.n, c.ns
                if n != c.taken_n or ns != c.taken_ns:
                    agg = side.setdefault(name, [0, 0])
                    agg[0] += n - c.taken_n
                    agg[1] += ns - c.taken_ns
                    c.taken_n, c.taken_ns = n, ns
            self._traced = now
        return now

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the body as the span ``name`` (host clock), nested in the
        span open around it on this thread; yields its :class:`Span`,
        whose ``end`` is set once the body is left."""
        traced = self._settle()
        stack = self._stack()
        rec = Span(name, stack[-1].name if stack else None, traced)
        host = _host_event(name) if traced else None
        stack.append(rec)
        if host is not None:
            host.__enter__()
        rec.start = time.perf_counter_ns()
        try:
            yield rec
        finally:
            rec.end = time.perf_counter_ns()
            if host is not None:
                host.__exit__(None, None, None)
            stack.pop()
            self._settle()
            ns = rec.end - rec.start
            with self._lock:
                self.records.append(rec)
                agg = self._spans[traced].setdefault(name, [0, 0, 0])
                agg[0] += 1
                agg[1] += ns
                agg[2] = max(agg[2], ns)

    def counter(self, name: str) -> Counter:
        """The counter ``name`` (one object a name), for its owner to add
        to in place."""
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def mark(self, name: str, device) -> None:
        """A device mark ``name``: a CUDA event with timing recorded on
        ``device``'s current stream (a ``torch.device`` of a tensor);
        nothing on another device, inside a stream capture, or where it
        repeats the device's latest mark (:class:`_MarkRing`)."""
        if device.type != "cuda":
            return
        import torch

        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        traced = profiling()
        ring = self._marks.get(index)
        if ((ring is not None and ring.repeats(name, traced))
                or torch.cuda.is_current_stream_capturing()):
            return
        stream = torch.cuda.current_stream(index)
        if ring is None:
            ring = self._marks[index] = _MarkRing(MARKS, stream)
        ring.record(name, traced, stream)

    # reading

    def spans(self, name: str, traced: bool = False) -> tuple:
        """``(count, total s, max s)`` of the spans ``name`` that opened
        while a profiler recorded (``traced``) or while none did."""
        with self._lock:
            count, total, most = self._spans[traced].get(name, (0, 0, 0))
        return count, total * 1e-9, most * 1e-9

    def counts(self, name: str, traced: bool = False) -> tuple:
        """``(count, host ns)`` of the counter ``name`` taken while a
        profiler recorded (``traced``) or while none did."""
        self._settle()
        with self._lock:
            return tuple(self._counts[traced].get(name, (0, 0)))

    def last(self, name: str):
        """The latest closed :class:`Span` ``name`` still in the ring, or
        None."""
        with self._lock:
            return next((r for r in reversed(self.records)
                         if r.name == name), None)

    def children(self, span: Span) -> list:
        """The closed spans still in the ring that ``span`` (closed) holds
        directly, oldest first."""
        with self._lock:
            return [r for r in self.records
                    if r.parent == span.name and span.start <= r.start
                    and r.end <= span.end and r is not span]

    def device_spans(self, first: str, last: str) -> list:
        """Seconds on the device's clock of each stretch from a ``first``
        mark to a ``last`` one still in the rings, its marks all made while
        no profiler recorded (:func:`pair_marks`); waits for the marks."""
        out = []
        for ring in list(self._marks.values()):
            for start, end in pair_marks(ring.oldest_first(), first, last):
                end.synchronize()
                out.append(start.elapsed_time(end) * 1e-3)
        return out


TRACER = Tracer()


class StageTimer:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.durations: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.verbose:
            print(f"{name}, starting time is: {datetime.now(timezone.utc)}")
        rec = None
        try:
            with TRACER.span(STAGE + name) as rec:
                yield
        finally:
            if rec is not None:
                dt = rec.seconds
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
