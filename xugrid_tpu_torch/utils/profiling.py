"""
Tracing and per-stage cost accounting, as in
``xugrid_tpu/utils/profiling.py``:

* ``trace(logdir)``: a ``torch.profiler`` capture of the block (host
  and, where a card is present, CUDA activity), written to ``logdir`` as
  a Chrome trace in TensorBoard's layout (``*.pt.trace.json``);
* ``annotate(name)``: a named region in that trace, and an NVTX range
  on the card;
* ``timings`` / ``timed``: a wall-clock registry of the host stages
  (index builds, candidate joins, exact overlap areas, file IO) that a
  device profiler cannot see;
* ``span`` / ``count``: named spans and counts on the per-call paths,
  recorded as a tree only between ``timings.start_spans()`` and
  ``timings.stop_spans()``.  While recording is off a span site costs
  one flag test; while a ``torch.profiler`` runs, each recorded span is
  also a ``record_function`` region of its trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, NamedTuple, Optional


class SpanRecord(NamedTuple):
    """One recorded span: ``parent`` is -1 for a span opened inside no
    other; ``root`` is the outermost span open at its start (itself if
    none), which every span of one public call shares.  Times are
    ``time.perf_counter_ns()``; ``end_ns`` is None for a span still open
    when recording stopped.  ``counts`` holds what ``count`` added while
    it was the innermost open span."""

    id: int
    parent: int
    root: int
    name: str
    start_ns: int
    end_ns: Optional[int]
    counts: dict


class _NoSpan:
    """The span of a site while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, traceback):
        return False


_NO_SPAN = _NoSpan()
_clock = time.perf_counter_ns


class _Recorder:
    """The one context of every span while recording.  The name comes
    from the ``span`` call just before; each open span is a tuple (name,
    start, record_function region or None) on the registry's stack, so
    spans close in the order they nest (in one thread); each closed span
    is a tuple (name, start, end, depth, counts) in the buffer, which
    nothing else refers to."""

    __slots__ = ("_registry",)

    def __init__(self, registry: "TimingRegistry"):
        self._registry = registry

    def __enter__(self):
        registry = self._registry
        name, region = registry._pending, None
        if registry._profiler._is_profiler_enabled:
            region = registry._profiler.record_function(name)
            region.__enter__()
        registry._stack.append((name, _clock(), region))
        return None

    def __exit__(self, kind, value, traceback):
        end = _clock()
        registry = self._registry
        stack = registry._stack
        if not stack:  # recording stopped inside the span
            return False
        name, start, region = stack.pop()
        depth = len(stack)
        counts = registry._open_counts.pop(depth, None) if registry._open_counts else None
        n = registry._size
        if n < registry._capacity:
            registry._buffer[n] = (name, start, end, depth, counts)
        registry._size = n + 1
        if region is not None:
            region.__exit__(None, None, None)
        return False


class _Timed:
    """A timed stage: its wall time added to the registry's totals, and,
    while recording, a span."""

    __slots__ = ("_registry", "_name", "_start", "_stack")

    def __init__(self, registry: "TimingRegistry", name: str):
        self._registry = registry
        self._name = name

    def __enter__(self):
        registry = self._registry
        self._stack = None
        if registry.recording:
            registry.span(self._name).__enter__()
            self._stack = registry._stack
        self._start = _clock()
        return None

    def __exit__(self, kind, value, traceback):
        end = _clock()
        registry = self._registry
        if self._stack is not None and self._stack is registry._stack:  # the same recording
            registry._recorder.__exit__(None, None, None)
        totals = registry._records[self._name]
        totals[0] += 1
        totals[1] += (end - self._start) * 1e-9
        return False


class TimingRegistry:
    """Accumulates (count, total seconds) per named stage; between
    ``start_spans`` and ``stop_spans`` it also records spans, with the
    ``timed`` stages among them, as a tree, and counts (``count``).
    Spans are recorded from one thread, into a preallocated list of
    tuples of numbers and names, which the garbage collector stops
    following once it has seen them."""

    def __init__(self):
        self._records: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        self._counters: Dict[str, int] = defaultdict(int)
        #: Whether spans are being recorded (``start_spans``); read only.
        self.recording = False
        self._recorder = _Recorder(self)
        self._pending = ""  # the name of the span about to open
        self._next_id = 0  # span ids run on across recordings
        self._buffer: list = []
        self._capacity = self._size = 0
        self._stack: list = []  # the open spans, outermost first
        self._open_counts: Dict[int, dict] = {}  # depth of an open span -> its counts
        self._profiler = None  # torch.autograd.profiler, while recording
        #: Spans closed while the buffer was full, in the last recording.
        self.dropped = 0

    def timed(self, name: str) -> _Timed:
        """A context that adds its wall time to stage ``name`` (and, while
        recording, records a span)."""
        return _Timed(self, name)

    def span(self, name: str):
        """A span of a per-call site: while recording, a record; otherwise
        a shared no-op.  Use as ``with span(name):``."""
        if not self.recording:
            return _NO_SPAN
        self._pending = name
        return self._recorder

    def count(self, name: str, n: int) -> None:
        """While recording, add ``n`` to counter ``name`` and to the
        innermost open span's counts; otherwise nothing."""
        if not self.recording:
            return
        self._counters[name] += n
        if self._stack:
            counts = self._open_counts.setdefault(len(self._stack) - 1, {})
            counts[name] = counts.get(name, 0) + n

    def start_spans(self, capacity: int = 1 << 20) -> None:
        """Record spans into a buffer of ``capacity`` records (spans past
        it are counted in ``dropped``), dropping any earlier recording."""
        import torch.autograd.profiler

        self._profiler = torch.autograd.profiler
        self._buffer = [None] * capacity
        self._capacity, self._size = capacity, 0
        self._stack, self._open_counts = [], {}
        self.dropped = 0
        self.recording = True

    def stop_spans(self) -> list:
        """Stop recording; the ``SpanRecord`` of each span recorded, in
        the order they opened (``end_ns`` None for one still open).  A
        span is written when it closes: a full buffer keeps the first to
        close.  Each span's parent is the span one level out whose
        interval holds it (-1 where that one was dropped)."""
        if not self.recording:
            return []
        self.recording = False
        closed = self._buffer[: min(self._size, self._capacity)]
        still_open = [
            (name, start, None, depth, self._open_counts.get(depth)) for depth, (name, start, _) in enumerate(self._stack)
        ]
        self.dropped = max(self._size - self._capacity, 0)
        self._buffer, self._stack, self._open_counts = [], [], {}
        records, path = [], []  # path: the records enclosing the next one
        for name, start, end, depth, counts in sorted(closed + still_open, key=lambda r: (r[1], r[3])):
            while path and (
                len(path) > depth or not (path[-1].end_ns is None or (end is not None and end <= path[-1].end_ns))
            ):
                path.pop()
            ident = self._next_id
            self._next_id += 1
            parent, root = (path[-1].id, path[0].root) if path else (-1, ident)
            record = SpanRecord(ident, parent, root, name, start, end, counts or {})
            records.append(record)
            path.append(record)
        return records

    def record(self, name: str, seconds: float) -> None:
        """Add one call of ``seconds`` to stage ``name``."""
        record = self._records[name]
        record[0] += 1
        record[1] += seconds

    def counters(self) -> Dict[str, int]:
        """What ``count`` added per name while recording."""
        return dict(self._counters)

    def summary(self) -> Dict[str, dict]:
        """Per stage, slowest first: count, total and mean seconds
        (rounded to microseconds)."""
        return {
            name: {
                "count": count,
                "total_s": round(total, 6),
                "mean_s": round(total / count, 6) if count else 0.0,
            }
            for name, (count, total) in sorted(self._records.items(), key=lambda kv: -kv[1][1])
        }

    def reset(self) -> None:
        self._records.clear()
        self._counters.clear()

    def report(self) -> str:
        """The summary as a text table."""
        lines = [f"{'stage':<40} {'count':>8} {'total s':>10} {'mean s':>10}"]
        for name, stats in self.summary().items():
            lines.append(f"{name:<40} {stats['count']:>8} {stats['total_s']:>10.4f} {stats['mean_s']:>10.6f}")
        return "\n".join(lines)


#: Registry used by the instrumented host stages.
timings = TimingRegistry()
timed = timings.timed
span = timings.span
count = timings.count


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block: CPU activity, and
    CUDA activity (kernels, copies) where a card is present.  On exit the
    trace is written into ``logdir`` as ``<host>_<pid>.<ns>.pt.trace.json``
    (Chrome trace format, TensorBoard's profiler layout)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace (``torch.profiler.record_function``),
    and an NVTX range for external CUDA profilers where a card is
    present."""
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
