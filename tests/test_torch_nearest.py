"""
The port's nearest-neighbour queries (``spatial/nearest.py``) held on the
CPU against the JAX package's.

- The host path (scipy's KDTree) is bit-equal to the JAX package's.
- The device scan (``nearest_scan``), forced with
  ``XUGRID_TPU_NEAREST=device`` on ``device="cpu"``, is held to the JAX
  package's ``_nearest_device`` path, forced the same way on the JAX CPU
  backend: equal indices, or neighbours at distances equal within rtol
  1e-5 (float32 near-ties may break either way).  Cases: several source
  tiles, ``max_distance`` (away from the boundary), UTM-sized coordinates
  of about 1e6.
- The dispatch: no device is resolved below the pair threshold; above
  it ``device=None`` raises without a CUDA card and ``device="cpu"``
  takes the KDTree.
"""

import numpy as np
import pytest
import torch

from xugrid_tpu.spatial import nearest as jax_nearest
from xugrid_tpu_torch.spatial import nearest


def problems():
    rng = np.random.default_rng(0)
    utm = np.array([4.5e5, 5.8e6])
    return {
        "uniform": (rng.uniform(0, 100, (500, 2)), rng.uniform(-10, 110, (300, 2))),
        "multi_tile": (rng.uniform(0, 1000, (2 * nearest.TILE + 37, 2)), rng.uniform(0, 1000, (250, 2))),
        "utm": (utm + rng.uniform(0, 5e3, (3000, 2)), utm + rng.uniform(-100, 5.1e3, (400, 2))),
        "clustered": (np.repeat(rng.uniform(0, 10, (40, 2)), 25, axis=0) + rng.normal(scale=1e-3, size=(1000, 2)),
                      rng.uniform(0, 10, (200, 2))),
    }


PROBLEMS = problems()


def equidistant(sources, queries, want, got, rtol=1e-5):
    """Equal indices, or neighbours at the same distance within rtol."""
    assert want.shape == got.shape
    np.testing.assert_array_equal(got < 0, want < 0)
    diff = (want != got) & (want >= 0)
    if diff.any():
        d_want = np.linalg.norm(sources[want[diff]] - queries[diff], axis=1)
        d_got = np.linalg.norm(sources[got[diff]] - queries[diff], axis=1)
        np.testing.assert_allclose(d_got, d_want, rtol=rtol)
    return int(diff.sum())


def test_constants_are_the_jax_packages():
    assert (nearest.TILE, nearest._MIN_WORK, nearest._MAX_SOURCES) == (
        jax_nearest.TILE, jax_nearest._MIN_WORK, jax_nearest._MAX_SOURCES
    )
    # Each (chunk, TILE) float32 intermediate stays at 256 MB.
    assert nearest.CHUNK * nearest.TILE * 4 == 256 << 20


@pytest.mark.parametrize("prebuilt", [False, True])
@pytest.mark.parametrize("max_distance", [np.inf, 3.0])
@pytest.mark.parametrize("mode", ["host", "auto"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_host_path_bit_equal(name, mode, max_distance, prebuilt, monkeypatch):
    from scipy.spatial import KDTree

    sources, queries = PROBLEMS[name]
    monkeypatch.setenv("XUGRID_TPU_NEAREST", mode)
    tree = KDTree(sources) if prebuilt else None
    want = jax_nearest.nearest_points(sources, queries, max_distance, tree=tree)
    got = nearest.nearest_points(sources, queries, max_distance, tree=tree)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_distance", [np.inf, "median"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_scan_matches_jax_device_path(name, max_distance, monkeypatch):
    sources, queries = PROBLEMS[name]
    if max_distance == "median":
        # A limit between neighbour distances: none lies within 1e-4 of it.
        d = np.linalg.norm(sources[jax_nearest.nearest_points(sources, queries)] - queries, axis=1)
        max_distance = float(np.median(d))
        near = np.abs(d - max_distance) < 1e-4 * max(max_distance, 1.0)
        queries = queries[~near]
    monkeypatch.setenv("XUGRID_TPU_NEAREST", "device")
    want = jax_nearest.nearest_points(sources, queries, max_distance)
    got = nearest.nearest_points(sources, queries, max_distance, device="cpu")
    assert got.dtype == np.int64
    n_diff = equidistant(sources, queries, want, got)
    assert n_diff <= len(queries) // 100
    if np.isfinite(max_distance):
        assert 0 < (got < 0).sum() < len(got)
    # The scan against the exact (KDTree) answer.
    monkeypatch.setenv("XUGRID_TPU_NEAREST", "host")
    equidistant(sources, queries, nearest.nearest_points(sources, queries, max_distance), got)


def test_scan_multi_tile_near_exact_hits(monkeypatch):
    rng = np.random.default_rng(5)
    sources = rng.uniform(0, 1000, (nearest.TILE * 2 + 37, 2))
    queries = sources[::97] + 1e-4
    monkeypatch.setenv("XUGRID_TPU_NEAREST", "device")
    got = nearest.nearest_points(sources, queries, device="cpu")
    np.testing.assert_array_equal(got, np.arange(0, len(sources), 97))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_scan_chunks_and_tiles_agree(chunk, monkeypatch):
    """Query chunks and a last partial tile give the one-chunk answer."""
    sources, queries = PROBLEMS["multi_tile"]
    q = torch.from_numpy(queries.astype(np.float32))
    s = torch.from_numpy(sources.astype(np.float32))
    want_d2, want_idx = nearest.scan_tiles(q, s)
    monkeypatch.setattr(nearest, "CHUNK", chunk)
    got_d2, got_idx = nearest.scan_tiles(q, s)
    assert torch.equal(got_idx, want_idx) and torch.equal(got_d2, want_d2)
    d2 = ((q[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    assert torch.equal(got_idx, d2.argmin(dim=1))


def test_scan_ties_go_to_the_lowest_index():
    """Duplicate sources, within a tile and across tiles."""
    base = np.random.default_rng(3).uniform(0, 10, (nearest.TILE + 5, 2))
    sources = np.concatenate([base, base[:10]])
    sources[7] = sources[3]
    q = torch.from_numpy(sources[[3, 7, 0, 9, nearest.TILE + 2]].astype(np.float32))
    _, idx = nearest.scan_tiles(q, torch.from_numpy(sources.astype(np.float32)))
    np.testing.assert_array_equal(idx.numpy(), [3, 3, 0, 9, nearest.TILE + 2])


def test_scan_empty_and_nan_queries():
    s = torch.rand(10, 2)
    d2, idx = nearest.scan_tiles(torch.empty(0, 2), s)
    assert d2.shape == (0,) and idx.shape == (0,)
    d2, idx = nearest.scan_tiles(torch.tensor([[np.nan, 0.5]], dtype=torch.float32), s)
    assert int(idx[0]) == -1 and bool(torch.isinf(d2[0]))


def test_max_distance_cases(monkeypatch):
    sources = np.array([[0.0, 0.0], [10.0, 0.0]])
    queries = np.array([[0.1, 0.0], [50.0, 50.0]])
    for mode in ("host", "device"):
        monkeypatch.setenv("XUGRID_TPU_NEAREST", mode)
        idx = nearest.nearest_points(sources, queries, max_distance=5.0, device="cpu")
        np.testing.assert_array_equal(idx, [0, -1])


def test_no_sources(monkeypatch):
    for mode in ("host", "device"):
        monkeypatch.setenv("XUGRID_TPU_NEAREST", mode)
        got = nearest.nearest_points(np.empty((0, 2)), np.ones((3, 2)), device="cpu")
        np.testing.assert_array_equal(got, jax_nearest.nearest_points(np.empty((0, 2)), np.ones((3, 2))))


def _refuse(*args, **kwargs):
    raise AssertionError("called")


def test_below_threshold_resolves_no_device(monkeypatch):
    monkeypatch.delenv("XUGRID_TPU_NEAREST", raising=False)
    monkeypatch.setattr(nearest, "resolve_device", _refuse)
    monkeypatch.setattr(nearest, "nearest_scan", _refuse)
    sources, queries = PROBLEMS["uniform"]
    np.testing.assert_array_equal(
        nearest.nearest_points(sources, queries), jax_nearest.nearest_points(sources, queries)
    )


@pytest.fixture
def threshold_problem():
    """2^18 queries against 2^18 sources: 2^36 pairs, the threshold."""
    rng = np.random.default_rng(1)
    n = 1 << 18
    return rng.uniform(0, 1, (n, 2)), rng.uniform(0, 1, (n, 2))


def test_above_threshold_needs_a_card_unless_cpu(threshold_problem, monkeypatch):
    sources, queries = threshold_problem
    monkeypatch.delenv("XUGRID_TPU_NEAREST", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nearest.nearest_points(sources, queries)
    monkeypatch.setenv("XUGRID_TPU_NEAREST", "device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nearest.nearest_points(sources[:10], queries[:10])
    # On the CPU the KDTree answers, as the JAX package's CPU backend does.
    monkeypatch.delenv("XUGRID_TPU_NEAREST")
    monkeypatch.setattr(nearest, "nearest_scan", _refuse)
    got = nearest.nearest_points(sources, queries[:2000], device="cpu")
    np.testing.assert_array_equal(got, jax_nearest.nearest_points(sources, queries[:2000]))
    got = nearest.nearest_points(sources, queries, device=torch.device("cpu"))
    assert got.shape == (len(queries),) and (got >= 0).all()
