"""The port's own spans and counts inside each regrid call, recorded by
``xugrid_tpu_torch.utils.profiling`` between ``start()`` and
``collect()`` on the host's ``time.perf_counter`` clock (the clock of
the harness's ``Call``), and what the per-layer metrics read of them.

A call's spans share the id of their root, the public ``regrid``: in it
``regrid.apply`` (the slab loop), per slab ``apply_weights`` around
``apply.kernel`` (the dispatch and the launch), and ``apply.concat``;
the counter ``apply.copy_bytes`` counts what the apply layer copies on
the device outside the kernels.  Only calls the profiler did not trace
are read.  A port without the recorder records nothing, and every
reader here then returns None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.tracing import CALL, DEVICE_CATEGORIES, _union, attribute_gaps

ROOT = "regrid"
APPLY = "regrid.apply"
KERNEL = "apply.kernel"
COPY_BYTES = "apply.copy_bytes"
#: The port's span names on the regrid path, as they appear in a trace.
PORT_SPANS = frozenset({ROOT, APPLY, "apply_weights", KERNEL, "apply.concat"})
#: The name of idle time that no port span covers.
OUTSIDE = "outside the port"


def _timings():
    from xugrid_tpu_torch.utils.profiling import timings

    return timings if hasattr(timings, "start_spans") else None


def start(capacity: int = 1 << 20) -> bool:
    """Start the port's span recording; False where the port has none."""
    timings = _timings()
    if timings is None:
        return False
    timings.start_spans(capacity)
    return True


def collect():
    """Stop the recording: its records, or None where the port has no
    recorder."""
    timings = _timings()
    return None if timings is None else timings.stop_spans()


def per_call(records, calls) -> list:
    """The records of each ``regrid`` root that started inside a call
    the profiler did not trace (nor failed), one list per call, the
    root first."""
    if not records:
        return []
    kept = sorted((round(c.start * 1e9), round(c.end * 1e9)) for c in calls if not c.traced and not c.failed)
    starts = [start for start, _ in kept]
    groups = defaultdict(list)
    for record in records:
        groups[record.root].append(record)
    out = []
    for root, group in groups.items():
        head = group[0]
        if head.id != root or head.name != ROOT or head.end_ns is None:
            continue
        i = bisect.bisect_right(starts, head.start_ns) - 1
        if i >= 0 and head.start_ns <= kept[i][1]:
            out.append(group)
    return out


def duration_ns(record) -> int:
    return record.end_ns - record.start_ns


def self_ns(record, group) -> int:
    """``record``'s time less that of its direct children."""
    return duration_ns(record) - sum(duration_ns(r) for r in group if r.parent == record.id)


def lead_us(group) -> float | None:
    """From the start of ``regrid`` to the end of its first
    ``apply.kernel``: the host time before the card has work."""
    kernels = [r for r in group if r.name == KERNEL]
    return (kernels[0].end_ns - group[0].start_ns) * 1e-3 if kernels else None


def wrapper_us(group) -> float:
    """The self time of ``regrid``: the labelled wrapper."""
    return self_ns(group[0], group) * 1e-3


def dispatch_us(group) -> float | None:
    """``regrid.apply`` less its ``apply.kernel`` spans: the slab loop,
    ``apply_weights`` and the concatenation's enqueue."""
    apply = [r for r in group if r.name == APPLY]
    if not apply:
        return None
    kernels = sum(duration_ns(r) for r in group if r.name == KERNEL)
    return (sum(duration_ns(r) for r in apply) - kernels) * 1e-3


def kernels(group) -> int:
    return sum(r.name == KERNEL for r in group)


def copy_gb(group) -> float:
    return sum(r.counts.get(COPY_BYTES, 0) for r in group) * 1e-9


def mean_per_call(ctx, quantity) -> float | None:
    """The mean of ``quantity(group)`` over the untraced calls' records;
    None where nothing was recorded."""
    values = [quantity(g) for g in per_call(getattr(ctx, "spans", None), ctx.calls)]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def kernel_us(ctx) -> float | None:
    """The mean duration of one ``apply.kernel`` span."""
    spans = [r for g in per_call(getattr(ctx, "spans", None), ctx.calls) for r in g if r.name == KERNEL]
    return 1e-3 * sum(duration_ns(r) for r in spans) / len(spans) if spans else None


def idle_by_span(events, names=PORT_SPANS) -> dict:
    """Seconds of the traced window's idle device time (no kernel, copy
    or memset running) by the innermost open port span, from the trace's
    ``user_annotation`` events (Python frames and the profiler's own
    operations are passed over); idle time no port span covers goes to
    ``OUTSIDE``.  Empty without traced calls."""
    calls = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == CALL]
    if not calls:
        return {}
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e["dur"] for e in calls)
    device = []
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATEGORIES:
            start, end = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if end > start:
                device.append((start, end))
    gaps, edge = [], lo
    for start, end in _union(device):
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    if hi > edge:
        gaps.append((edge, hi))
    host = [(lo - 1, hi + 1, OUTSIDE)]  # below every span: what no port span covers
    host += [
        (e["ts"], e["ts"] + e["dur"], e["name"])
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") in names and "dur" in e
    ]
    return dict(attribute_gaps(gaps, host)) if gaps else {}


def idle_line(split: dict) -> str:
    """The stderr line of ``idle_by_span``'s split, most first."""
    total = sum(split.values())
    parts = ", ".join(f"{name} {seconds:.6g} s" for name, seconds in sorted(split.items(), key=lambda kv: -kv[1]))
    return f"idle by port span: {parts} (sum {total:.6g} s)"
