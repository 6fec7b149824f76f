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
  device profiler cannot see.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class TimingRegistry:
    """Accumulates (count, total seconds) per named stage."""

    def __init__(self):
        self._records: Dict[str, list] = defaultdict(lambda: [0, 0.0])

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            record = self._records[name]
            record[0] += 1
            record[1] += time.perf_counter() - t0

    def record(self, name: str, seconds: float) -> None:
        """Add one call of ``seconds`` to stage ``name``."""
        record = self._records[name]
        record[0] += 1
        record[1] += seconds

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

    def report(self) -> str:
        """The summary as a text table."""
        lines = [f"{'stage':<40} {'count':>8} {'total s':>10} {'mean s':>10}"]
        for name, stats in self.summary().items():
            lines.append(f"{name:<40} {stats['count']:>8} {stats['total_s']:>10.4f} {stats['mean_s']:>10.6f}")
        return "\n".join(lines)


#: Registry used by the instrumented host stages.
timings = TimingRegistry()
timed = timings.timed


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
