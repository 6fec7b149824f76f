"""
The port's ``utils/profiling.py`` held to the JAX package's
(``tests/test_profiling.py``'s four cases: the registry, the instrumented
grid hash, and the native grid hash and face boxes against numpy), and
``trace()``/``annotate()`` on the CPU: the trace written into the log
directory names the annotated region and the work inside it.
"""

import json

import numpy as np
import pytest
import torch

from xugrid_tpu.utils.profiling import TimingRegistry as JaxTimingRegistry
from xugrid_tpu_torch.utils.profiling import TimingRegistry, annotate, timings, trace


def test_timing_registry():
    reg = TimingRegistry()
    with reg.timed("stage.a"):
        pass
    with reg.timed("stage.a"):
        pass
    reg.record("stage.b", 0.5)
    summary = reg.summary()
    assert summary["stage.a"]["count"] == 2
    assert summary["stage.b"]["total_s"] == 0.5
    report = reg.report()
    assert "stage.a" in report and "stage.b" in report
    reg.reset()
    assert reg.summary() == {}


def test_registry_summary_and_report_match_jax():
    reports = []
    for cls in (JaxTimingRegistry, TimingRegistry):
        reg = cls()
        for name, seconds in (("stage.b", 0.25), ("stage.a", 1.5), ("stage.b", 0.125), ("stage.c", 1e-7)):
            reg.record(name, seconds)
        reports.append((reg.summary(), reg.report()))
    assert reports[1] == reports[0]
    assert list(reports[1][0]) == ["stage.a", "stage.b", "stage.c"]


def test_global_registry_instrumented_by_grid_hash():
    from xugrid_tpu_torch.spatial.grid_hash import GridHash

    timings.reset()
    boxes = np.array([[0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 2.0, 1.0]])
    gh = GridHash(boxes)
    gh.query_points(np.array([[0.5, 0.5]]))
    gh.query_boxes(np.array([[0.0, 0.0, 2.0, 1.0]]))
    summary = timings.summary()
    assert "grid_hash.build" in summary
    assert "grid_hash.query_points" in summary
    assert "grid_hash.query_boxes" in summary
    timings.reset()


def test_native_grid_hash_matches_jax():
    """The port's grid hash (native) against the JAX package's numpy
    binning and queries, on tests/test_profiling.py's seeded boxes."""
    from xugrid_tpu.spatial.grid_hash import GridHash as JaxGridHash
    from xugrid_tpu.utils import native as jnative
    from xugrid_tpu_torch.spatial.grid_hash import GridHash

    if jnative.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)
    lo = rng.uniform(0, 100, (500, 2))
    size = rng.uniform(0.1, 3.0, (500, 2))
    boxes = np.column_stack([lo, lo + size])
    port = GridHash(boxes)
    lib = jnative._LIB
    jnative._LIB = None
    try:
        plain = JaxGridHash(boxes)
    finally:
        jnative._LIB = lib
    np.testing.assert_array_equal(port.bin_start, plain.bin_start)
    np.testing.assert_array_equal(port.bin_prims, plain.bin_prims)
    queries = np.column_stack([rng.uniform(0, 100, (200, 2)), rng.uniform(0, 100, (200, 2))])
    queries = np.column_stack([np.minimum(queries[:, :2], queries[:, 2:]), np.maximum(queries[:, :2], queries[:, 2:])])
    for got, want in zip(port.query_boxes(queries), plain.query_boxes(queries)):
        np.testing.assert_array_equal(got, want)
    pts = rng.uniform(-1, 101, (300, 2))
    pts[7] = np.nan
    for tol in (0.0, 0.05, 2.0):
        q1, p1 = port.query_points(pts, tol)
        jnative._LIB = None
        try:
            q2, p2 = plain.query_points(pts, tol)
        finally:
            jnative._LIB = lib
        key1 = np.sort(q1.astype(np.int64) * len(boxes) + p1)
        key2 = np.sort(q2.astype(np.int64) * len(boxes) + p2)
        np.testing.assert_array_equal(key1, key2)


def test_native_face_bbox_matches_jax():
    from xugrid_tpu.spatial.bvh import face_bounding_boxes as jax_face_bounding_boxes
    from xugrid_tpu.utils import native as jnative
    from xugrid_tpu_torch.utils.native import face_bbox_native

    if jnative.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(4)
    nodes = rng.uniform(0, 10, (50, 2))
    faces = rng.integers(0, 50, (30, 4)).astype(np.int64)
    faces[::3, 3] = -1  # triangles
    got = face_bbox_native(faces, nodes[:, 0], nodes[:, 1])
    lib = jnative._LIB
    jnative._LIB = None
    try:
        want = jax_face_bounding_boxes(faces, nodes[:, 0], nodes[:, 1])
    finally:
        jnative._LIB = lib
    np.testing.assert_allclose(got, want)


def test_trace_names_the_annotated_region(tmp_path):
    a = torch.arange(64.0).reshape(8, 8)
    with trace(tmp_path):
        with annotate("phase16.apply"):
            b = a @ a
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    assert "phase16.apply" in names
    region = next(e for e in events if e.get("name") == "phase16.apply")
    inside = [
        e for e in events
        if e.get("name") == "aten::mm" and region["ts"] <= e["ts"] <= region["ts"] + region["dur"]
    ]
    assert inside, "the matrix product is not inside the annotated region"
    assert torch.equal(b, a @ a)


def test_annotate_outside_a_trace_is_transparent():
    with annotate("outside"):
        x = torch.ones(3) * 2
    assert x.tolist() == [2.0, 2.0, 2.0]
    with pytest.raises(KeyError):
        with annotate("raises"):
            raise KeyError("propagates")


# Spans and the apply layer's counters: a CPU regrid of a 6 x 5 quad
# mesh onto a 3 x 3 raster, three slices applied in three slabs, each
# slab written in place into one output.

#: The spans of ``test_spans_under_a_profiler_are_nested_trace_regions``: each
#: lasts long beside a trace region's own enter and exit (``regrid.wrap``,
#: tens of microseconds onto a raster, is left out).
SPAN_NAMES = ("regrid", "regrid.apply", "apply_weights", "apply.kernel")


def quad_mesh_uda(nx=6, ny=5, slices=3):
    import xugrid_tpu_torch as xt

    x, y = np.meshgrid(np.arange(nx + 1, dtype=float), np.arange(ny + 1, dtype=float))
    nodes = np.column_stack([x.ravel(), y.ravel()])
    i, j = np.meshgrid(np.arange(nx), np.arange(ny))
    first = (j * (nx + 1) + i).ravel()
    faces = np.column_stack([first, first + 1, first + nx + 2, first + nx + 1])
    grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    values = torch.from_numpy(np.random.default_rng(5).normal(size=(slices, len(faces))).astype(np.float32))
    return xt.UgridDataArray(xt.xdata.DataArray(values, dims=("time", grid.face_dimension), name="head"), grid)


def raster_target(nx=3, ny=3, cell=2.0):
    import xugrid_tpu_torch as xt

    coords = {"y": (np.arange(ny) + 0.5) * cell, "x": (np.arange(nx) + 0.5) * cell, "dx": cell, "dy": cell}
    return xt.xdata.DataArray(np.zeros((ny, nx)), coords=coords, dims=("y", "x"), name="map")


def slab_regrid(monkeypatch, uda, target, per_slab=1, method="mean"):
    """A regrid call of ``uda`` onto ``target`` in slabs of ``per_slab``
    slices."""
    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid import regridder as torch_regridder

    regridder = xt.OverlapRegridder(uda, target, method=method)
    per_slice = 4 * (regridder._weights.m + regridder._weights.n)
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", per_slab * per_slice)
    regridder.regrid(uda, device="cpu")  # the weights uploaded before any recording
    return lambda: regridder.regrid(uda, device="cpu")


@pytest.fixture
def sliced_regrid(monkeypatch):
    """A regrid call whose three slices go through three slabs."""
    return slab_regrid(monkeypatch, quad_mesh_uda(), raster_target())


def recorded(call):
    timings.reset()
    timings.start_spans()
    try:
        out = call()
    finally:
        records = timings.stop_spans()
    return out, records


def window_sum(values, weights):
    """A custom reduction: each window's weighted sum."""
    return torch.nansum(values * weights, dim=-1)


#: case -> (method, slices, slices a slab, bytes a slab copies on the CPU)
SLAB_CASES = {
    "three_slabs": ("mean", 3, 1, 1 * 9 * 4),
    "one_slab": ("mean", 3, 3, 3 * 9 * 4),
    "custom_three_slabs": (window_sum, 6, 2, 30 * 2 * 4 + 2 * 9 * 4),
}


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_regrid_records_its_span_tree_and_copy_bytes(monkeypatch, case):
    """Three slabs write their rows of one output in place (no
    concatenation): on the CPU each copies the plain kernel's (1, 9)
    result into its rows.  One slab takes the kernel's own output,
    counts no slab in place, and copies the plain kernel's transposed (3,
    9) result as before.  A custom reduction in three slabs of two
    slices copies each slab's (30, 2) slice-minor source and its (2, 9)
    result into its rows."""
    method, slices, per_slab, slab_bytes = SLAB_CASES[case]
    slabs = slices // per_slab
    uda = quad_mesh_uda(slices=slices)
    out, records = recorded(slab_regrid(monkeypatch, uda, raster_target(), per_slab, method))
    by_id = {r.id: r for r in records}
    assert [r.name for r in records] == (
        ["regrid", "regrid.apply"] + ["apply_weights", "apply.kernel"] * slabs + ["regrid.wrap"]
    )
    root = records[0]
    assert root.parent == -1 and {r.root for r in records} == {root.id}
    for r in records[1:]:
        parent = by_id[r.parent]
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
        expected = {
            "regrid.apply": "regrid", "apply_weights": "regrid.apply", "apply.kernel": "apply_weights",
            "regrid.wrap": "regrid",
        }[r.name]
        assert parent.name == expected
    assert out.shape == (slices, 3, 3)
    apply = next(r for r in records if r.name == "regrid.apply")
    assert apply.counts == ({"apply.slabs_in_place": slabs} if slabs > 1 else {})
    copied = [  # per slab: apply_weights and its apply.kernel
        outer.counts.get("apply.copy_bytes", 0) + inner.counts.get("apply.copy_bytes", 0)
        for outer, inner in zip(records[2::2], records[3::2])
    ]
    assert copied == [slab_bytes] * slabs
    assert timings.counters() == {**apply.counts, "apply.copy_bytes": sum(copied)}
    assert timings.summary() == {}  # spans keep no stage totals
    timings.reset()


def test_window_select_records_its_span_inside_apply_kernel(monkeypatch):
    """A median regrid of three slices in three slabs: each slab's
    ``apply.select`` nests in its ``apply.kernel`` and counts the E x n
    windows it ranks and the bytes of the plain result it copies into its
    rows of the output; on the CPU nothing launches, so no walk is
    counted; with recording off nothing is left."""
    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid import regridder as torch_regridder

    uda = quad_mesh_uda()
    regridder = xt.OverlapRegridder(uda, raster_target(), method="median")
    n = regridder._weights.n
    monkeypatch.setattr(torch_regridder, "APPLY_CHUNK_BYTES", 4 * (regridder._weights.m + n))
    out, records = recorded(lambda: regridder.regrid(uda, device="cpu"))
    by_id = {r.id: r for r in records}
    assert [r.name for r in records] == (
        ["regrid", "regrid.apply"] + ["apply_weights", "apply.kernel", "apply.select"] * 3 + ["regrid.wrap"]
    )
    for r in records:
        if r.name == "apply.select":
            parent = by_id[r.parent]
            assert parent.name == "apply.kernel" and parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
            assert r.counts == {"select.windows": 1 * n, "apply.copy_bytes": 1 * n * 4}
    assert timings.counters()["select.windows"] == 3 * n and "select.walk_launches" not in timings.counters()
    timings.reset()
    regridder.regrid(uda, device="cpu")
    assert timings.stop_spans() == [] and timings.counters() == {}
    torch.testing.assert_close(regridder.regrid(uda, device="cpu").data, out.data, rtol=0, atol=0, equal_nan=True)


def test_apply_counts_a_cast_that_copies_and_not_one_that_does_not():
    from xugrid_tpu_torch.core.sparse import MatrixCOO, PaddedCSR
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights

    weights = PaddedCSR.from_coo(
        MatrixCOO.from_triplet(np.array([0, 0, 1]), np.array([0, 1, 2]), np.array([1.0, 1.0, 2.0]), n=2, m=3)
    )
    source = torch.arange(12.0, dtype=torch.float32).reshape(4, 3)
    counted = {}
    for dtype in ("float32", "float64"):
        timings.reset()
        timings.start_spans()
        out = apply_weights(weights, source, reduce.mean, 2, dtype=dtype)
        records = timings.stop_spans()
        counted[dtype] = timings.counters().get("apply.copy_bytes", 0)
        assert [r.name for r in records] == ["apply_weights", "apply.kernel"]
        assert sum(r.counts.get("apply.copy_bytes", 0) for r in records) == counted[dtype]
    # On the CPU the plain kernel returns its (E, n) result as a transposed
    # view, which the apply copies; float64 adds the cast of the source.
    assert counted == {"float32": 4 * 2 * 4, "float64": source.numel() * 8 + 4 * 2 * 8}
    assert out.dtype == torch.float64
    timings.reset()


def test_recording_off_leaves_nothing_and_never_annotates(sliced_regrid, monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    timings.reset()
    sliced_regrid()
    with trace(tmp_path):
        out = sliced_regrid()
    assert out.shape == (3, 3, 3)
    assert not timings.recording
    assert timings.stop_spans() == []
    assert timings.summary() == {} and timings.counters() == {}


def test_spans_under_a_profiler_are_nested_trace_regions(monkeypatch, tmp_path):
    # Slabs of 100 slices of 50,000 faces onto as many cells, so that each
    # span lasts long beside a trace region's own enter and exit.
    regrid = slab_regrid(monkeypatch, quad_mesh_uda(250, 200, 300), raster_target(250, 200, 1.0), per_slab=100)
    timings.start_spans()
    try:
        with trace(tmp_path / "warm"):  # the process's first regions set up the profiler's ops
            regrid()
        timings.start_spans()
        with trace(tmp_path / "checked"):
            regrid()
    finally:
        records = [r for r in timings.stop_spans() if r.name in SPAN_NAMES]
    timings.reset()
    events = json.loads(next((tmp_path / "checked").glob("*.pt.trace.json")).read_text())["traceEvents"]
    regions = sorted(
        (e for e in events if e.get("cat") == "user_annotation" and e.get("name") in SPAN_NAMES), key=lambda e: e["ts"]
    )
    assert [e["name"] for e in regions] == [r.name for r in records]
    assert set(SPAN_NAMES) == {r.name for r in records}
    for region, record in zip(regions, records):
        if record.parent >= 0:
            parent = regions[[r.id for r in records].index(record.parent)]
            assert parent["ts"] <= region["ts"] and region["ts"] + region["dur"] <= parent["ts"] + parent["dur"]
        in_memory = (record.end_ns - record.start_ns) * 1e-3
        assert abs(region["dur"] - in_memory) <= max(0.1 * in_memory, 50.0)


def test_span_buffer_stops_at_capacity_and_counts_dropped():
    # A span is written when it closes: the first three to close are kept.
    reg = TimingRegistry()
    reg.start_spans(capacity=3)
    with reg.span("a"):
        with reg.span("b"):
            pass
        with reg.span("c"):
            with reg.span("d"):
                reg.count("n", 2)
            with reg.span("e"):
                pass
    records = reg.stop_spans()
    assert [r.name for r in records] == ["b", "d", "e"]
    assert reg.dropped == 2
    assert reg.counters() == {"n": 2} and records[1].counts == {"n": 2}
    assert all(r.parent == -1 and r.root == r.id and r.end_ns is not None for r in records)


def test_timed_stages_hang_under_the_open_span():
    reg = TimingRegistry()
    with reg.timed("stage.before"):
        pass
    reg.start_spans()
    with reg.span("call"):
        with reg.timed("stage.inner"):
            reg.count("n", 1)
    with reg.timed("stage.alone"):
        pass
    records = reg.stop_spans()
    with reg.timed("stage.after"):
        pass
    call, inner, alone = records
    assert (call.name, inner.name, alone.name) == ("call", "stage.inner", "stage.alone")
    assert inner.parent == call.id and inner.root == call.id and inner.counts == {"n": 1}
    assert alone.parent == -1 and alone.root == alone.id and call.counts == {}
    assert {name: stats["count"] for name, stats in reg.summary().items()} == {
        "stage.before": 1, "stage.inner": 1, "stage.alone": 1, "stage.after": 1
    }
    assert reg.stop_spans() == [] and not reg.recording


def test_summary_and_report_match_jax_while_recording():
    reports = []
    for cls in (JaxTimingRegistry, TimingRegistry):
        reg = cls()
        if cls is TimingRegistry:
            reg.start_spans()
        for name, seconds in (("stage.b", 0.25), ("stage.a", 1.5), ("stage.b", 0.125), ("stage.c", 1e-7)):
            reg.record(name, seconds)
        if cls is TimingRegistry:
            assert reg.stop_spans() == []
        reports.append((reg.summary(), reg.report()))
    assert reports[1] == reports[0]


def test_spans_open_when_recording_stops_end_unknown():
    reg = TimingRegistry()
    reg.start_spans()
    outer = reg.span("outer")
    outer.__enter__()
    stage = reg.timed("stage")
    stage.__enter__()
    records = reg.stop_spans()
    assert [(r.name, r.end_ns) for r in records] == [("outer", None), ("stage", None)]
    assert records[1].parent == records[0].id
    stage.__exit__(None, None, None)  # closed with no recording running: only the totals
    outer.__exit__(None, None, None)
    assert reg.stop_spans() == [] and list(reg.summary()) == ["stage"]
    reg.start_spans()
    with reg.span("next"):
        pass
    stage.__exit__(None, None, None)  # a stage of the last recording leaves this one alone
    assert [(r.name, r.parent) for r in reg.stop_spans()] == [("next", -1)]


def test_centroid_regrid_records_its_apply_span():
    import xugrid_tpu_torch as xt

    uda = quad_mesh_uda()
    regridder = xt.CentroidLocatorRegridder(uda, raster_target())
    out, records = recorded(lambda: regridder.regrid(uda, device="cpu"))
    timings.reset()
    assert out.shape == (3, 3, 3)
    assert [(r.name, r.parent) for r in records] == [
        ("regrid", -1), ("regrid.apply", records[0].id), ("regrid.wrap", records[0].id)
    ]
