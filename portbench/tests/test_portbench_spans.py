"""The readers of the port's own spans (``portbench/spans.py``): on
hand-made records and a hand-made Chrome trace, then on the records of
real CPU regrid calls, and the run without a trace that starts no
recorder and reads no span metric."""

import json
import subprocess
import sys

import pytest

from portbench import harness, spans, tracing
from portbench.harness import Call, Context
from portbench.tests.small import REPO, run_cpu, small_root
from portbench.tests.test_portbench_isolation import top_level_modules

SPAN_METRICS = (
    "regrid.lead_us", "regrid.wrapper_us", "regrid.dispatch_us",
    "apply.kernel_us", "apply.kernels_per_call", "apply.copy_gb_per_call",
)


def record(ident, parent, root, name, start_us, end_us, **counts):
    from xugrid_tpu_torch.utils.profiling import SpanRecord

    return SpanRecord(ident, parent, root, name, int(start_us * 1e3), int(end_us * 1e3), counts)


def one_call(base, root):
    """A regrid of two slabs at ``base`` us: 10 us of wrapper before the
    apply, each slab 5 us of dispatch around a 20 us kernel span, an
    8 us concatenation that copies 1000 bytes, 2 us of wrapper after."""
    r = root
    return [
        record(r, -1, r, "regrid", base, base + 80),
        record(r + 1, r, r, "regrid.apply", base + 10, base + 78),
        record(r + 2, r + 1, r, "apply_weights", base + 10, base + 35),
        record(r + 3, r + 2, r, "apply.kernel", base + 15, base + 35),
        record(r + 4, r + 1, r, "apply_weights", base + 35, base + 60),
        record(r + 5, r + 4, r, "apply.kernel", base + 40, base + 60),
        record(r + 6, r + 1, r, "apply.concat", base + 60, base + 68, **{"apply.copy_bytes": 1000}),
    ]


def call(start_us, end_us, traced=False, failed=False):
    return Call(start_us * 1e-6, end_us * 1e-6, end_us * 1e-6, 1, traced, failed)


def context(records, calls):
    ctx = Context(calls, 1.0, 0.0)
    ctx.spans = records
    return ctx


def test_per_call_keeps_only_roots_inside_untraced_calls():
    records = one_call(1000, 0) + one_call(2000, 10) + one_call(3000, 20) + one_call(9000, 30)
    calls = [call(990, 1100), call(1990, 2100, traced=True), call(2990, 3100, failed=True)]
    groups = spans.per_call(records, calls)
    assert [g[0].id for g in groups] == [0]
    assert spans.per_call([], calls) == [] and spans.per_call(None, calls) == []


def test_self_times_subtract_only_direct_children():
    group = one_call(0, 0)
    root, apply = group[0], group[1]
    assert spans.self_ns(root, group) == (80 - 68) * 1000  # less regrid.apply alone
    assert spans.self_ns(apply, group) == (68 - 58) * 1000  # less both apply_weights and the concat
    assert spans.wrapper_us(group) == pytest.approx(12.0)
    assert spans.dispatch_us(group) == pytest.approx(68 - 40)
    assert spans.wrapper_us(group) + spans.dispatch_us(group) + 40 == pytest.approx(80)


def test_lead_ends_at_the_first_kernel_span():
    group = one_call(500, 0)
    assert spans.lead_us(group) == pytest.approx(35.0)
    assert spans.lead_us(group[:3]) is None


def test_metrics_read_the_untraced_calls():
    records = one_call(1000, 0) + one_call(2000, 10)
    ctx = context(records, [call(990, 1100), call(1990, 2100)])
    read = {name: harness.spec.load_module(REPO, "metrics", name).read(ctx) for name in SPAN_METRICS}
    assert read == pytest.approx({
        "regrid.lead_us": 35.0, "regrid.wrapper_us": 12.0, "regrid.dispatch_us": 28.0,
        "apply.kernel_us": 20.0, "apply.kernels_per_call": 2.0, "apply.copy_gb_per_call": 1e-6,
    })
    for ctx in (Context([call(990, 1100)], 1.0, 0.0), context([], [call(990, 1100)])):
        assert all(harness.spec.load_module(REPO, "metrics", n).read(ctx) is None for n in SPAN_METRICS)


def chrome_trace():
    """Two traced calls, each 100 us: a port span tree over a kernel,
    with Python frames and a profiler op the split passes over."""
    events = []
    for base in (0, 100):
        events += [
            {"ph": "X", "cat": "user_annotation", "name": tracing.CALL, "ts": base, "dur": 100},
            {"ph": "X", "cat": "user_annotation", "name": "regrid", "ts": base + 5, "dur": 60},
            {"ph": "X", "cat": "user_annotation", "name": "regrid.apply", "ts": base + 20, "dur": 40},
            {"ph": "X", "cat": "user_annotation", "name": "apply.kernel", "ts": base + 30, "dur": 10},
            {"ph": "X", "cat": "python_function", "name": "aligned_apply.py(136): window_reduce", "ts": base + 31, "dur": 8},
            {"ph": "X", "cat": "cpu_op", "name": "cudaDeviceSynchronize", "ts": base + 65, "dur": 30},
            {"ph": "X", "cat": "kernel", "name": "window_reduce_kernel", "ts": base + 40, "dur": 50},
        ]
    return events


def test_idle_by_span_sums_to_the_trace_idle_and_names_the_rest():
    events = chrome_trace()
    split = spans.idle_by_span(events)
    summary = tracing.summarize(events)
    assert sum(split.values()) == pytest.approx(summary.window_s - summary.busy_s, rel=1e-12)
    # Per call: idle 0-5 outside, 5-20 regrid, 20-30 regrid.apply,
    # 30-40 apply.kernel, 90-100 outside.
    assert split == pytest.approx({
        spans.OUTSIDE: 2 * 15e-6, "regrid": 2 * 15e-6, "regrid.apply": 2 * 10e-6, "apply.kernel": 2 * 10e-6
    })
    assert spans.idle_by_span([e for e in events if e["name"] != tracing.CALL]) == {}
    assert spans.idle_line(split).startswith("idle by port span: ")


def test_the_port_records_what_the_readers_read(tmp_path, monkeypatch):
    """A traced window of small CPU regrids, recorded as the harness
    records it: the untraced calls' spans give every metric, the apply
    in its slabs, and the idle split of the traced calls."""
    from xugrid_tpu_torch.regrid import regridder

    root = small_root(tmp_path, time=3, layer=2)
    benchmark = harness.spec.load(root)
    workload = harness.spec.cell(benchmark, "lhm250.heads_year")
    traffic = harness.spec.traffic(root, workload["traffic"])
    config = harness.spec.config(root, benchmark, workload["config"])
    import torch

    run = harness.Run(workload, config, traffic, 7, torch.device("cpu"))
    from portbench.generators.regrid_loop import Generator

    generator = Generator(run)
    generator.setup()
    weights = generator.regridder._weights
    monkeypatch.setattr(regridder, "APPLY_CHUNK_BYTES", 2 * 4 * (weights.m + weights.n))  # slabs of 2 of 6 slices
    traces, summarize = [], tracing.summarize

    def keep(events):  # the trace's events, as the harness would keep them for idle_by_span
        traces.append(events)
        return summarize(events)

    monkeypatch.setattr(tracing, "summarize", keep)
    tracer = tracing.Tracer(0.0, 2, True, False)
    tracer.warm()
    assert spans.start()
    calls, window_s, error = harness.window(generator, 0.3, harness.Keeper(2, 7), tracer, run.device)
    records = spans.collect()
    assert error is None and sum(c.traced for c in calls) == 2
    ctx = context(records, calls)
    read = {name: harness.spec.load_module(REPO, "metrics", name).read(ctx) for name in SPAN_METRICS}
    assert read["apply.kernels_per_call"] == 3.0
    # On the CPU each slab's result is a transposed view that the apply
    # copies, then the concatenation copies all six slices again.
    assert read["apply.copy_gb_per_call"] == pytest.approx(2 * 6 * generator.raster.size * 4 * 1e-9)
    host_us = harness.spec.load_module(REPO, "metrics", "regrid.host_us_per_call").read(ctx)
    inside = read["regrid.wrapper_us"] + read["regrid.dispatch_us"] + 3 * read["apply.kernel_us"]
    assert 0 < read["regrid.lead_us"] < inside <= host_us
    split = spans.idle_by_span(traces[-1])
    assert set(split) >= {spans.OUTSIDE, "regrid", "apply.kernel"}
    assert sum(split.values()) == pytest.approx(tracer.summary.window_s - tracer.summary.busy_s, rel=0.01)


def test_a_run_without_a_trace_starts_no_recorder(tmp_path, monkeypatch):
    from xugrid_tpu_torch.utils.profiling import timings

    def refuse(*args, **kwargs):
        raise AssertionError("the recorder started in a run without a trace")

    monkeypatch.setattr(timings, "start_spans", refuse)
    result, _ = run_cpu(small_root(tmp_path), "lhm250.heads_year", seconds=0.2)
    assert result["correct"] and not set(result["metrics"]) & set(SPAN_METRICS)
    assert not timings.recording


def test_the_span_readers_load_no_jax():
    from portbench.harness import FORBIDDEN_MODULES

    assert not top_level_modules(["portbench.spans"]) & FORBIDDEN_MODULES
    probe = (
        f"import json, sys; sys.path.insert(0, {str(REPO)!r}); from portbench import spans; "
        "spans.start(); spans.collect(); print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    )
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, check=True, timeout=300)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "xugrid_tpu_torch" in loaded and not loaded & FORBIDDEN_MODULES
