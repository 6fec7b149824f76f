"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, the metrics, and the result line.

The cell (``BENCHMARK.json``) names a configuration file and a traffic
file; the traffic file's ``generator`` names a module of ``generators/``,
which builds the inputs and the port's state from the seed, makes one
call of the traffic, and judges what the calls produced against
``reference/``.  The window is a closed loop: each call is synchronised
before the next starts, and it closes at the first call that ends
``seconds`` or more after it opened.  Every metric is a reader of its own
(``metrics/<name>.py``), given a ``Context``.
"""

from __future__ import annotations

import importlib
import math
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import inputs, spec

#: Top-level module names no run may load: JAX, and the JAX package the
#: port was made from (compared whole: ``xugrid_tpu_torch`` is the port).
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "xugrid_tpu"})

#: Calls the reservoir of kept outputs plans for (more are never kept).
MAX_CALLS = 1 << 21


def forbidden_modules() -> list:
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN_MODULES})


@dataclass
class Run:
    """What a generator is given: the cell, its configuration and traffic,
    the seed and the device."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: object  # torch.device
    marks: list = field(default_factory=list)  # (set-up stage, host clock at its end)

    def mark(self, stage: str) -> None:
        self.marks.append((stage, time.perf_counter()))


@dataclass
class Call:
    start: float  # host clock at the call
    returned: float  # when the call returned, before the synchronise
    end: float  # after the synchronise
    units: int  # slices or jobs the call completed
    traced: bool
    failed: bool
    counters: dict | None = None  # what the generator read of the port after the call

    @property
    def latency(self) -> float:
        return self.end - self.start


@dataclass
class Context:
    """What a metric reader reads."""

    calls: list
    window_s: float
    setup_s: float
    trace: object = None  # tracing.TraceSummary of the traced calls, if any
    counts: dict = field(default_factory=dict)  # the generator's byte-count inputs

    def untraced(self) -> list:
        return [c for c in self.calls if not c.traced and not c.failed]


class Keeper:
    """A reservoir of ``size`` call outputs, drawn uniformly over the
    window from the seed, and the last call's."""

    def __init__(self, size: int, seed: int):
        generator = inputs.rng(seed, inputs.KEEP)
        k = np.arange(size, MAX_CALLS)
        replace = k[generator.random(len(k)) < size / (k + 1.0)]
        self.plan = dict(zip(range(size), range(size)))
        self.plan.update(zip(replace.tolist(), generator.integers(0, size, len(replace)).tolist()))
        self.kept = [None] * size
        self.last = None

    def offer(self, k: int, out) -> None:
        slot = self.plan.get(k)
        if slot is not None:
            self.kept[slot] = (k, out)
        self.last = (k, out)

    def outputs(self) -> list:
        held = {k: out for k, out in filter(None, self.kept)}
        if self.last is not None:
            held.setdefault(*self.last)
        return sorted(held.items(), key=lambda kv: kv[0])


def synchronize(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(generator, seconds: float, keeper: Keeper, tracer, device) -> tuple:
    """Calls until one ends ``seconds`` or more after the window opened.
    Returns (calls, window seconds, the first failure's traceback)."""
    import torch

    calls, first_error, k = [], None, 0
    opened = time.perf_counter()
    while True:
        traced = tracer is not None and tracer.active(time.perf_counter() - opened)
        failed, out, units = False, None, 0
        annotation = torch.profiler.record_function("portbench.call") if traced else None
        if annotation is not None:
            annotation.__enter__()
        start = time.perf_counter()
        try:
            out, units = generator.call(k)
        except Exception:  # a call that raises counts as failed; the run goes on
            failed = True
            first_error = first_error or traceback.format_exc()
        returned = time.perf_counter()
        synchronize(device)
        end = time.perf_counter()
        if annotation is not None:
            annotation.__exit__(None, None, None)
        calls.append(Call(start, returned, end, units, traced, failed, None if failed else generator.counters()))
        if not failed:
            keeper.offer(k, out)
        if traced:
            tracer.finished_call()
        k += 1
        if end - opened >= seconds:
            return calls, end - opened, first_error


def counter_means(context: Context) -> list:
    """Means over the untraced calls of what the generator read of the port
    after each call (stage seconds, solve diagnostics)."""
    sums, counts = {}, {}
    for call in context.untraced():
        for group, values in (call.counters or {}).items():
            for name, value in values.items():
                if isinstance(value, (int, float)) and not isinstance(value, bool):
                    key = f"{group}.{name}"
                    sums[key] = sums.get(key, 0.0) + value
                    counts[key] = counts.get(key, 0) + 1
    if not sums:
        return []
    return ["port counters, mean per call: " + ", ".join(f"{k} {sums[k] / counts[k]:.6g}" for k in sorted(sums))]


def read_metrics(root: Path, entries: list, context: Context) -> dict:
    """Each metric's reader applied to the context; a reader that finds
    nothing to read (None) leaves its metric out."""
    values = {}
    for entry in entries:
        value = spec.load_module(root, "metrics", entry["name"]).read(context)
        if value is not None:
            values[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return values


def device_info(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


def run(root, workload_name: str, seed: int, seconds: float, trace: bool, device, started: float) -> tuple:
    """One run of a cell on ``device``.  Returns (result, stderr lines):
    the result is the dict the last line of standard output prints."""
    from portbench.tracing import Tracer

    root = Path(root)
    benchmark = spec.load(root)
    workload = spec.cell(benchmark, workload_name)
    traffic = spec.traffic(root, workload["traffic"])
    this = Run(workload, spec.config(root, benchmark, workload["config"]), traffic, seed, device)
    this.mark("harness")
    generator = importlib.import_module(f"portbench.generators.{traffic['generator']}").Generator(this)
    generator.setup()
    tracer = None
    if trace:
        plan = traffic["trace"]
        tracer = Tracer(plan["after_s"], plan["calls"], plan.get("stack", False), device.type == "cuda")
        tracer.warm()
        this.mark("profiler")
    keeper = Keeper(traffic["keep_calls"], seed)
    opened = time.perf_counter()
    setup_s = opened - started
    calls, window_s, first_error = window(generator, seconds, keeper, tracer, device)
    info = device_info(device, workload["chips"])
    kept = keeper.outputs()
    generator.release()
    checked = time.perf_counter()
    checks = generator.check(kept)
    checked = time.perf_counter() - checked
    counts = generator.counts()
    failed = sum(c.failed for c in calls)
    correct = bool(kept) and failed == 0 and all(value <= limit for value, limit in checks.values())
    context = Context(calls, window_s, setup_s, tracer.summary if tracer else None, counts)
    result = {
        "correct": correct,
        "attempted": len(calls),
        "failed": failed,
        "metrics": read_metrics(root, spec.metrics(benchmark, workload, trace), context),
        "device": info,
    }
    if context.trace is not None:
        result["device"]["busy_s"] = context.trace.busy_s
        result["device"]["window_s"] = context.trace.window_s
        result["breakdown"] = {"device_ops": context.trace.device_ops, "idle_gaps": context.trace.idle_gaps}
    result["checks"] = {name: {"value": value, "limit": limit} for name, (value, limit) in checks.items()}
    lines = [] if first_error is None else [f"first failed call:\n{first_error}"]
    lines += generator.notes()
    lines += counter_means(context)
    latencies = sorted(c.latency for c in context.untraced())
    if len(latencies) >= 4:
        q1, q2, q3 = statistics.quantiles(latencies, n=4)
        lines += [
            f"untraced call latency s: min {latencies[0]:.6g}, quartiles {q1:.6g} {q2:.6g} {q3:.6g}, "
            f"max {latencies[-1]:.6g}"
        ]
    previous = started
    stages = []
    for stage, at in this.marks:
        stages.append(f"{stage} {at - previous:.3f}")
        previous = at
    lines += [f"set-up s by stage: {', '.join(stages)}"]
    lines += [f"kept calls {[k for k, _ in kept]} of {len(calls)}, judged in {checked:.3f} s"]
    lines += [f"check {name} {value!r} limit {limit!r}" for name, (value, limit) in checks.items()]
    return result, lines


def look_for_chips(count: int):
    """The first card, when ``count`` cards are present; else None."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        return None
    return torch.device("cuda", 0)


def finite(value):
    """A JSON-safe number: NaN and infinities as strings."""
    return value if isinstance(value, (int, str)) or math.isfinite(value) else str(value)
