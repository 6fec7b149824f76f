"""What the metric readers (``metrics/<name>.py``) share."""

from __future__ import annotations

import numpy as np

from portbench import rooflines


def p95(values) -> float | None:
    return float(np.percentile(values, 95)) if len(values) else None


def slices_per_s(ctx) -> float:
    """Every slice regridded in the window over the window's seconds."""
    return sum(c.units for c in ctx.calls if not c.failed) / ctx.window_s


def host_us_per_call(ctx) -> float | None:
    """Mean host time from the call until it returns, before the
    synchronise, over the untraced calls, in us."""
    calls = ctx.untraced()
    return 1e6 * sum(c.returned - c.start for c in calls) / len(calls) if calls else None


def stage_mean(ctx, names) -> float | None:
    """Mean seconds per untraced call of the port's ``timings`` stages
    ``names`` (summed); None when no call recorded any of them."""
    calls = [c for c in ctx.untraced() if c.counters and any(n in c.counters["stages"] for n in names)]
    if not calls:
        return None
    return sum(sum(c.counters["stages"].get(n, 0.0) for n in names) for c in calls) / len(calls)


def idle_pct(ctx) -> float | None:
    """The share of a call in which no operation runs on the device: the
    traced calls' busy device seconds per call over the untraced calls'
    mean latency (the profiler slows the host, not the device)."""
    calls = ctx.untraced()
    if ctx.trace is None or not ctx.trace.calls or not calls:
        return None
    latency = sum(c.latency for c in calls) / len(calls)
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.calls / latency)


def window_reduce_share(ctx) -> float | None:
    """The frozen bytes of a launch over its mean device time.  A call of
    E slices may launch the kernel more than once (the port applies a
    deep stack in slabs); the bytes are linear in E, so each launch is
    given the mean slab, E x traced calls / launches."""
    shapes = ctx.counts.get("window_reduce")
    found = ctx.trace.kernel("window_reduce_kernel") if ctx.trace is not None else None
    if shapes is None or found is None or not ctx.trace.calls:
        return None
    launches, seconds = found
    E = shapes["E"] * ctx.trace.calls / launches
    nbytes = rooflines.window_reduce_bytes(shapes["nnz"], shapes["m"], shapes["n"], E)
    return rooflines.share_pct(nbytes, seconds / launches)
