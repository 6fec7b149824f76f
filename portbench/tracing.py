"""A ``torch.profiler`` capture of a bounded part of the window, and what
the per-layer metrics read from it: device time by kernel, the busy
union of device operations, and idle gaps named by what the host was
doing.  The Chrome trace is written under ``TMPDIR`` and removed once
read."""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

#: Chrome-trace categories of operations that run on the device.
DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
#: Host-side categories that can name an idle gap.
HOST_CATEGORIES = {"cpu_op", "user_annotation", "python_function"}
#: The annotation around each traced call (its synchronise included).
CALL = "portbench.call"


@dataclass
class TraceSummary:
    calls: int  # traced calls
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)  # name -> [launches, seconds]
    device_ops: list = field(default_factory=list)  # [name, seconds], most first
    idle_gaps: list = field(default_factory=list)  # [host activity, seconds], most first

    def kernel(self, fragment: str):
        """(launches, seconds) of the kernels whose name holds
        ``fragment``; None if none ran."""
        launches = seconds = 0
        for name, (count, total) in self.kernels.items():
            if fragment in name:
                launches += count
                seconds += total
        return (launches, seconds) if launches else None


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def attribute_gaps(gaps: list, host: list) -> dict:
    """Seconds of the idle ``gaps`` by the innermost host activity (the
    latest started of those still running) at each moment; time that no
    traced host activity covers goes to one name of its own."""
    idle = defaultdict(float)
    host = sorted(host)
    times = sorted({t for start, end, _ in host for t in (start, end)} | {t for gap in gaps for t in gap})
    gap_starts = np.array([g[0] for g in gaps])
    gap_ends = np.array([g[1] for g in gaps])
    stack, pending = [], 0
    for t0, t1 in zip(times[:-1], times[1:]):
        while pending < len(host) and host[pending][0] <= t0:
            stack.append(host[pending])
            pending += 1
        while stack and stack[-1][1] <= t0:
            stack.pop()
        g = np.searchsorted(gap_starts, t0, side="right") - 1
        if g < 0 or gap_ends[g] < t1:
            continue  # the device was busy
        name = stack[-1][2] if stack else "host, outside any traced op"
        idle[name] += (t1 - t0) * 1e-6
    return idle


def summarize(events: list) -> TraceSummary | None:
    """The summary of a Chrome trace's events (times in microseconds)
    over the span of its ``portbench.call`` annotations; None when it
    holds no traced call."""
    calls = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == CALL]
    if not calls:
        return None
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e["dur"] for e in calls)
    device, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if end <= start:
            continue
        if e.get("cat") in DEVICE_CATEGORIES:
            device.append((start, end))
            by_name[e["name"]] += (end - start) * 1e-6
            if e["cat"] == "kernel":
                kernels[e["name"]][0] += 1
                kernels[e["name"]][1] += e["dur"] * 1e-6
        elif e.get("cat") in HOST_CATEGORIES and e.get("name") != CALL:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    busy = _union(device)
    gaps, edge = [], lo
    for start, end in busy:
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    if hi > edge:
        gaps.append((edge, hi))
    idle = attribute_gaps(gaps, host)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return TraceSummary(
        calls=len(calls),
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(end - start for start, end in busy) * 1e-6,
        kernels={k: list(v) for k, v in kernels.items()},
        device_ops=top(by_name),
        idle_gaps=top(idle),
    )


class Tracer:
    """Profiles ``calls`` window calls, starting with the first call at
    least ``after_s`` into the window (Python frames too when
    ``stack``)."""

    def __init__(self, after_s: float, calls: int, stack: bool, cuda: bool):
        self.after_s, self.calls, self.stack, self.cuda = after_s, calls, stack, cuda
        self.profile = None
        self.done = 0
        self.summary = None

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        return profile(activities=activities, with_stack=self.stack)

    def warm(self) -> None:
        """Profile a trivial op once, so that the profiler's own start-up
        falls into set-up."""
        import torch

        with self._profiler():
            x = torch.ones(8, device="cuda" if self.cuda else "cpu")
            (x + x).sum().item()

    def active(self, elapsed: float) -> bool:
        """Whether the next call is traced (starts the profile if due)."""
        if self.profile is None and self.done < self.calls and elapsed >= self.after_s:
            self.profile = self._profiler()
            self.profile.start()
        return self.profile is not None

    def finished_call(self) -> None:
        if self.profile is None:
            return
        self.done += 1
        if self.done >= self.calls:
            self.profile.stop()
            fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
            os.close(fd)
            try:
                self.profile.export_chrome_trace(path)
                with open(path) as f:
                    self.summary = summarize(json.load(f)["traceEvents"])
            finally:
                os.unlink(path)
            self.profile = None
