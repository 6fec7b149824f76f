"""
Stored regridder weights held on the CPU against the JAX package:
every regridder class (overlap mean, mode and median, relative overlap,
centroid locator, barycentric interpolator, network gridder), from mesh
and raster sources onto mesh and raster targets, is stored with
``to_dataset`` by one package, written to netCDF (scipy engine) or zarr
in ``tmp_path``, and reloaded with ``from_dataset`` by both.

- The reloaded weights equal the written ones bit for bit, in both
  packages, and ``weights_as_dataframe`` agrees.
- The port's CPU regrid through the reloaded weights matches the JAX
  regrid through its reloaded weights at ``tests/test_torch_wrap.py``'s
  tolerances (float64 rtol 1e-12; selections and the centroid gather
  bit for bit), with the same dims, coordinates, name and attrs; and
  where the port wrote the file, its reloaded regrid equals its fresh
  one bit for bit.
- A reloaded regridder has its source grid again: a labelled regrid
  checks the source dimensions, and the regrid runs on the card unless
  asked for the CPU.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from tests.test_torch_wrap import assert_same_labelled, inputs, make, objects, values_of  # noqa: F401

PACKAGES = {"jax": xu, "torch": xt}
FORMATS = ["nc", "zarr"]
CASES = [
    ("OverlapRegridder", "mean", "mesh", "raster"),
    ("OverlapRegridder", "mean", "fine raster", "mesh"),
    ("OverlapRegridder", "mode", "mesh", "raster"),
    ("OverlapRegridder", "median", "mesh", "mesh"),
    ("RelativeOverlapRegridder", None, "mesh", "raster"),
    ("RelativeOverlapRegridder", None, "fine raster", "raster"),
    ("CentroidLocatorRegridder", None, "mesh", "raster"),
    ("CentroidLocatorRegridder", None, "fine raster", "mesh"),
    ("BarycentricInterpolator", None, "mesh", "raster"),
    ("BarycentricInterpolator", None, "fine raster", "mesh"),
    ("BarycentricInterpolator", None, "fine raster", "raster"),
    ("NetworkGridder", "mean", "network", "mesh"),
    ("NetworkGridder", "mode", "network", "raster"),
]
IDS = [f"{cls}-{method}-{src}->{tgt}" for cls, method, src, tgt in CASES]


def sources(pkg, data):
    objs = objects(pkg, data, np.float64)
    network = pkg.Ugrid1d(data["nodes"][:, 0], data["nodes"][:, 1], -1, data["edges"])
    da = pkg.xdata.DataArray(data["network"], dims=("time", network.edge_dimension), name="q",
                             coords={"time": [1.0, 2.0, 3.0]})
    objs["network"] = pkg.UgridDataArray(da, network)
    return objs


def build(pkg, cls, method, source, target):
    if cls == "NetworkGridder":
        return pkg.NetworkGridder(source, target, method=method)
    return make(pkg, cls, source, target, method)


def write(ds, path, fmt):
    (ds.to_netcdf if fmt == "nc" else ds.to_zarr)(path)


def read(pkg, path, fmt):
    if fmt == "nc":
        return pkg.xdata.open_dataset(path, engine="scipy")
    return pkg.xdata.open_zarr(path)


def load(pkg, cls, method, ds):
    """The regridder stored in ``ds``, with ``method`` (None: the class's
    default).  The JAX package's ``from_dataset`` takes no method: its
    ``from_weights`` does."""
    klass = getattr(pkg, cls)
    if method is None:
        return klass.from_dataset(ds)
    if pkg is xt:
        return klass.from_dataset(ds, method=method)
    return klass.from_weights(ds, klass.from_dataset(ds)._target, method=method)


def assert_weights_bit_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for field, a, b in zip(want._fields, got, want):
        if np.ndim(b):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
            assert np.asarray(a).dtype.kind == np.asarray(b).dtype.kind, field
        else:
            assert int(a) == int(b), field


def frame(regridder):
    df = regridder.weights_as_dataframe()
    return df.astype({"target_index": np.int64, "source_index": np.int64})


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("cls, method, src, tgt", CASES, ids=IDS)
def test_stored_weights_reload_in_both_packages(tmp_path, inputs, cls, method, src, tgt, writer, fmt):  # noqa: F811
    objs = {name: sources(pkg, inputs) for name, pkg in PACKAGES.items()}
    fresh = build(PACKAGES[writer], cls, method, objs[writer][src], objs[writer][tgt])
    path = tmp_path / f"weights.{fmt}"
    write(fresh.to_dataset(), path, fmt)
    loaded = {name: load(pkg, cls, method, read(pkg, path, fmt)) for name, pkg in PACKAGES.items()}
    for name in PACKAGES:
        assert_weights_bit_equal(loaded[name]._weights, fresh._weights)
    pd.testing.assert_frame_equal(frame(loaded["torch"]), frame(loaded["jax"]))
    pd.testing.assert_frame_equal(frame(loaded["torch"]), frame(fresh))

    want = loaded["jax"].regrid(objs["jax"][src])
    got = loaded["torch"].regrid(objs["torch"][src], device="cpu")
    exact = method in ("mode", "median") or cls == "CentroidLocatorRegridder"
    assert_same_labelled(want, got, exact, np.float64)
    if writer == "torch":
        again = values_of(fresh.regrid(objs["torch"][src], device="cpu"))
        np.testing.assert_array_equal(values_of(got), again)


def test_weights_as_dataframe_matches_jax(inputs):  # noqa: F811
    objs = {name: sources(pkg, inputs) for name, pkg in PACKAGES.items()}
    for cls, method, src, tgt in CASES:
        got = build(xt, cls, method, objs["torch"][src], objs["torch"][tgt]).weights_as_dataframe()
        want = build(xu, cls, method, objs["jax"][src], objs["jax"][tgt]).weights_as_dataframe()
        assert list(got.columns) == ["target_index", "source_index", "weight"]
        np.testing.assert_array_equal(got["target_index"], want["target_index"])
        np.testing.assert_array_equal(got["source_index"], want["source_index"])
        np.testing.assert_allclose(got["weight"], want["weight"], rtol=1e-12, atol=0)


def test_loaded_regridder_keeps_its_source(tmp_path, inputs):  # noqa: F811
    objs = sources(xt, inputs)
    fresh = xt.OverlapRegridder(objs["fine raster"], objs["mesh"], device="cpu")
    fresh.to_dataset().to_netcdf(tmp_path / "w.nc")
    loaded = xt.OverlapRegridder.from_dataset(xt.xdata.open_dataset(tmp_path / "w.nc"))
    assert loaded._source.dims == fresh._source.dims == ("y", "x")
    assert loaded._target.ugrid_topology.name == "__target"
    flat = objs["fine raster"].rename({"y": "row"})
    for regridder in (fresh, loaded):
        with pytest.raises(ValueError, match="does not contain regridder source dimensions"):
            regridder.regrid(flat, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loaded.regrid(objs["fine raster"])
    # A regridder made from weight arrays has no source grid to store.
    w = fresh._weights
    carried = xt.OverlapRegridder.from_csr_arrays(w.data, w.indices, w.indptr, w.n, w.m, objs["mesh"])
    with pytest.raises(ValueError, match="knows no source grid"):
        carried.to_dataset()
    # Stored weights carry the index dtypes the apply expects.
    assert loaded._weights.indices.dtype == np.int64 and loaded._weights.indptr.dtype == np.int64
