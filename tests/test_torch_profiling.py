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
