"""
The port's UGRID conventions and topology serialization held on the CPU
against the JAX package's, through files in ``tmp_path``: one package
writes a UGRID dataset (scipy netCDF or zarr), the other opens it.

- ``ugrid_roles`` of the opened file gives the same topologies,
  coordinates, dimensions, connectivity, grid mappings and projection
  in both packages: one topology, two (a 2D mesh and a 1D network), a
  dataset with no conventions, and a topology whose dimensions and
  coordinate roles must be inferred.
- ``Ugrid2d`` / ``Ugrid1d.from_dataset`` of the opened file equal the
  grid written, array for array and attribute for attribute: triangles
  and quads mixed, ``start_index=1``, a fill value of -999, and
  ``optional_attributes=True``; and their ``to_dataset`` equals the
  other package's, variable for variable.
- ``open_dataset`` / ``open_zarr`` of a ``.ugrid.to_netcdf`` /
  ``.ugrid.to_zarr`` file give the same UgridDataset in both packages:
  grids, data, coordinates and attributes bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt

PACKAGES = {"jax": xu, "torch": xt}
#: (writer, reader): each package reads the other's files.
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]
FORMATS = ["nc", "zarr"]


def write(ds, path, fmt):
    (ds.to_netcdf if fmt == "nc" else ds.to_zarr)(path)


def read(pkg, path, fmt):
    if fmt == "nc":
        return pkg.xdata.open_dataset(path, engine="scipy")
    return pkg.xdata.open_zarr(path)


def mixed_mesh(pkg, **kwargs):
    """Two quads and two triangles; connectivity in the given fill value
    and start index."""
    x = np.array([0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 3.0, 3.0])
    y = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 1.0])
    faces = np.array([[0, 1, 4, 3], [1, 2, 5, 4], [2, 6, 5, -1], [6, 7, 5, -1]])
    fill, start = kwargs.get("fill_value", -1), kwargs.get("start_index", 0)
    conn = np.where(faces >= 0, faces + start, fill)
    return pkg.Ugrid2d(x, y, fill, conn, name=kwargs.get("name", "mesh2d"), start_index=start)


def network(pkg, **kwargs):
    fill, start = kwargs.get("fill_value", -1), kwargs.get("start_index", 0)
    edges = np.array([[0, 1], [1, 2], [1, 3]]) + start
    return pkg.Ugrid1d([0.0, 1.0, 2.0, 1.5], [0.0, 1.0, 0.5, 2.0], fill, edges, name="network1d", start_index=start)


def one_topology(pkg):
    grid = mixed_mesh(pkg)
    ds = grid.to_dataset()
    ds["data"] = pkg.xdata.DataArray(np.arange(4.0), dims=(grid.face_dimension,))
    return ds


def two_topologies(pkg):
    return mixed_mesh(pkg).to_dataset().merge(network(pkg).to_dataset())


def no_conventions(pkg):
    return pkg.xdata.Dataset({"v": pkg.xdata.DataArray(np.arange(3.0), dims=("i",))})


def inferred(pkg):
    """A topology declaring only its face dimension, whose node
    coordinates carry no standard_name and whose connectivity is stored
    transposed: the node dimension and the coordinate roles are
    inferred."""
    ds = pkg.xdata.Dataset()
    ds["mesh"] = ((), np.int32(0), {
        "cf_role": "mesh_topology",
        "topology_dimension": 2,
        "face_dimension": "nFaces",
        "node_coordinates": "nx ny",
        "face_node_connectivity": "fnc",
        "face_coordinates": "fx fy",
    })
    ds["nx"] = (("nNodes",), np.array([0.0, 1.0, 1.0, 0.0]))
    ds["ny"] = (("nNodes",), np.array([0.0, 0.0, 1.0, 1.0]))
    ds["fx"] = (("nFaces",), np.array([0.5, 0.5]), {"standard_name": "longitude"})
    ds["fy"] = (("nFaces",), np.array([0.3, 0.7]), {"standard_name": "latitude"})
    ds["fnc"] = (("nMax", "nFaces"), np.array([[0, 0], [1, 2], [2, 3]]), {"start_index": 0})
    return ds


ROLE_CASES = {"one": one_topology, "two": two_topologies, "none": no_conventions, "inferred": inferred}


def roles_of(ds, pkg):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        roles = pkg.ugrid_roles(ds)
        out = {
            "topology": roles.topology,
            "coordinates": roles.coordinates,
            "dimensions": roles.dimensions,
            "connectivity": roles.connectivity,
            "grid_mapping_names": roles.grid_mapping_names,
            "is_projected": roles.is_projected,
            "repr": repr(roles),
        }
    return out, sorted(str(w.message) for w in caught)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer, reader", DIRECTIONS)
@pytest.mark.parametrize("case", sorted(ROLE_CASES))
def test_ugrid_roles_match_jax(tmp_path, case, writer, reader, fmt):
    path = tmp_path / f"roles.{fmt}"
    write(ROLE_CASES[case](PACKAGES[writer]), path, fmt)
    got = roles_of(read(PACKAGES[reader], path, fmt), PACKAGES[reader])
    want = roles_of(read(PACKAGES[writer], path, fmt), PACKAGES[writer])
    assert got == want
    assert len(got[0]["topology"]) == {"one": 1, "two": 2, "none": 0, "inferred": 1}[case]
    if case == "inferred":
        assert got[0]["dimensions"]["mesh"] == {"face_dimension": "nFaces", "node_dimension": "nNodes"}
        assert got[0]["is_projected"]["mesh"] is False  # from the face coordinates' standard_name


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
def test_inferred_topology_reads_as_jax(tmp_path, writer, reader):
    """The transposed connectivity of the inferred case comes back face-major."""
    path = tmp_path / "inferred.nc"
    write(inferred(PACKAGES[writer]), path, "nc")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = PACKAGES[reader].Ugrid2d.from_dataset(read(PACKAGES[reader], path, "nc"))
        want = PACKAGES[writer].Ugrid2d.from_dataset(read(PACKAGES[writer], path, "nc"))
    np.testing.assert_array_equal(got.face_node_connectivity, [[0, 1, 2], [0, 2, 3]])
    assert_grids_equal(got, want)


GRID_CASES = {
    "mixed": (mixed_mesh, {}, False),
    "start_index_1": (mixed_mesh, {"start_index": 1}, False),
    "fill_value_-999": (mixed_mesh, {"fill_value": -999}, False),
    "optional_attributes": (mixed_mesh, {"start_index": 1, "fill_value": -999}, True),
    "network": (network, {}, False),
    "network_start_index_1_fill_-5": (network, {"start_index": 1, "fill_value": -5}, True),
}


def assert_grids_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.fill_value, got.start_index) == (want.name, want.fill_value, want.start_index)
    assert got.attrs == want.attrs
    assert got.sizes == want.sizes and got.is_projected == want.is_projected
    np.testing.assert_array_equal(got.node_x, want.node_x)
    np.testing.assert_array_equal(got.node_y, want.node_y)
    np.testing.assert_array_equal(got.edge_node_connectivity, want.edge_node_connectivity)
    if want.topology_dimension == 2:
        np.testing.assert_array_equal(got.face_node_connectivity, want.face_node_connectivity)
        assert got.face_node_connectivity.dtype == np.int64


def assert_datasets_equal(got, want):
    """Same variables, coordinate names, dims, attrs and values (bit for
    bit, NaN equal), and the same global attrs."""
    assert sorted(got._variables) == sorted(want._variables)
    assert got._coord_names == want._coord_names
    assert got.attrs == want.attrs
    for name, var in want._variables.items():
        other = got._variables[name]
        assert other.dims == var.dims, name
        assert other.attrs == var.attrs, name
        np.testing.assert_array_equal(other.values, np.asarray(var.data), err_msg=name)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer, reader", DIRECTIONS)
@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_grid_from_the_other_packages_file(tmp_path, case, writer, reader, fmt):
    make, kwargs, optional = GRID_CASES[case]
    written = make(PACKAGES[writer], **kwargs)
    path = tmp_path / f"grid.{fmt}"
    write(written.to_dataset(optional_attributes=optional), path, fmt)
    cls = type(make(PACKAGES[reader], **kwargs))
    got = cls.from_dataset(read(PACKAGES[reader], path, fmt))
    want = type(written).from_dataset(read(PACKAGES[writer], path, fmt))
    assert got.equals(cls.from_dataset(read(PACKAGES[reader], path, fmt)))
    assert_grids_equal(got, written)
    assert_grids_equal(got, want)
    # Written again, each package gives the same UGRID dataset.
    assert_datasets_equal(got.to_dataset(optional_attributes=optional), want.to_dataset(optional_attributes=optional))


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_to_dataset_matches_jax(case):
    make, kwargs, optional = GRID_CASES[case]
    got = make(xt, **kwargs).to_dataset(optional_attributes=optional)
    want = make(xu, **kwargs).to_dataset(optional_attributes=optional)
    assert_datasets_equal(got, want)
    topology = got[make(xt, **kwargs).name]
    assert topology.attrs["cf_role"] == "mesh_topology"


def test_sparse_face_node_connectivity():
    from xugrid_tpu_torch.ugrid import connectivity

    grid = mixed_mesh(xt)
    # Unsorted CSR keeps each face's node order.
    sparse = connectivity.to_sparse(grid.face_node_connectivity, sort_indices=False)
    for csr_or_coo in (sparse, sparse.tocoo()):
        again = xt.Ugrid2d(grid.node_x, grid.node_y, -1, csr_or_coo)
        np.testing.assert_array_equal(again.face_node_connectivity, grid.face_node_connectivity)
        assert again.equals(grid)
        want = xu.Ugrid2d(grid.node_x, grid.node_y, -1, csr_or_coo)
        np.testing.assert_array_equal(again.face_node_connectivity, want.face_node_connectivity)
    np.testing.assert_array_equal(grid.format_connectivity_as_dense(sparse), grid.face_node_connectivity)
    np.testing.assert_array_equal(
        grid.format_connectivity_as_sparse(grid.face_node_connectivity).toarray(),
        xu.Ugrid2d.format_connectivity_as_sparse(grid.face_node_connectivity).toarray(),
    )


def test_rename_matches_jax():
    for pkg in (xu, xt):
        grid = mixed_mesh(pkg)
        grid.edge_node_connectivity  # noqa: B018  (derive the edges)
    got, got_names = mixed_mesh(xt).rename("renamed", return_name_dict=True)
    want, want_names = mixed_mesh(xu).rename("renamed", return_name_dict=True)
    assert got_names == want_names
    assert got.face_dimension == "renamed_nFaces" == want.face_dimension
    assert_datasets_equal(got.to_dataset(), want.to_dataset())


def ugrid_dataset(pkg, payload):
    grid = mixed_mesh(pkg, start_index=1, fill_value=-999)
    times = np.array(["2020-01-01", "2020-01-02T06:00", "NaT"], dtype="datetime64[ns]")
    face = pkg.xdata.DataArray(payload, dims=("time", grid.face_dimension), coords={"time": times},
                               attrs={"units": "m", "long_name": "level"})
    uds = pkg.UgridDataset(grids=[grid])
    uds["level"] = pkg.UgridDataArray(face, grid)
    uds["depth"] = pkg.UgridDataArray(pkg.xdata.DataArray(np.arange(8, dtype=np.int32), dims=(grid.node_dimension,)),
                                      grid)
    return uds


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer, reader", DIRECTIONS)
def test_open_dataset_matches_jax(tmp_path, writer, reader, fmt):
    values = np.random.default_rng(5).normal(size=(3, 4)).astype(np.float32)
    values[1, 2] = np.nan
    payload = torch.from_numpy(values) if writer == "torch" else values
    uds = ugrid_dataset(PACKAGES[writer], payload)
    path = tmp_path / f"uds.{fmt}"
    (uds.ugrid.to_netcdf if fmt == "nc" else uds.ugrid.to_zarr)(path)
    opener = {"nc": "open_dataset", "zarr": "open_zarr"}[fmt]
    got = getattr(PACKAGES[reader], opener)(path)
    want = getattr(PACKAGES[writer], opener)(path)
    assert isinstance(got, xt.UgridDataset if reader == "torch" else xu.UgridDataset)
    assert [g.name for g in got.grids] == ["mesh2d"] == [g.name for g in want.grids]
    assert_grids_equal(got.grid, want.grid)
    assert_grids_equal(got.grid, uds.grid)
    assert_datasets_equal(got.obj, want.obj)
    level = got["level"]
    np.testing.assert_array_equal(level.values, values)
    assert level.values.dtype == np.float32 and level.attrs == {"units": "m", "long_name": "level"}
    assert np.isnat(got.obj["time"].values[2])
    # An opened payload lies on the host, in native byte order.
    if reader == "torch":
        assert isinstance(level.data, np.ndarray) and level.data.dtype.isnative
        tensor, want_tensor = torch.from_numpy(level.data), torch.from_numpy(values)
        assert torch.equal(tensor.isnan(), want_tensor.isnan())
        assert torch.equal(tensor.nan_to_num(7.0), want_tensor.nan_to_num(7.0))
        assert got.ugrid.names == ["mesh2d"] and got.ugrid.total_bounds == (0.0, 0.0, 3.0, 1.0)


def test_open_dataarray_and_mfdataset(tmp_path):
    grid = mixed_mesh(xt)
    first = grid.create_data_array(np.arange(4.0), "face").rename("a")
    first.ugrid.to_netcdf(tmp_path / "a.nc")
    second = grid.create_data_array(np.arange(4.0) * 2.0, "face").rename("b")
    second.ugrid.to_netcdf(tmp_path / "b.nc")
    one = xt.open_dataarray(tmp_path / "a.nc")
    assert isinstance(one, xt.UgridDataArray) and one.name == "a"
    np.testing.assert_array_equal(one.values, np.arange(4.0))
    np.testing.assert_array_equal(xt.load_dataarray(tmp_path / "b.nc").values, np.arange(4.0) * 2.0)
    both = xt.open_mfdataset(str(tmp_path / "*.nc"))
    assert sorted(both.obj.data_vars) == ["a", "b"] and both.grid.equals(xt.load_dataset(tmp_path / "a.nc").grid)
    (tmp_path / "more").mkdir()
    both.ugrid.to_netcdf(tmp_path / "more" / "ab.nc")
    with pytest.raises(ValueError, match="more than one data variable"):
        xt.open_dataarray(tmp_path / "more" / "ab.nc")
    xt.xdata.Dataset({"v": xt.xdata.DataArray(np.arange(3.0), dims=("i",))}).to_netcdf(tmp_path / "plain.nc")
    with pytest.raises(ValueError, match="does not contain UGRID conventions"):
        xt.open_dataset(tmp_path / "plain.nc")


def test_accessor_members_match_jax():
    grids = {}
    for name, pkg in PACKAGES.items():
        uds = pkg.UgridDataset(two_topologies(pkg))
        grids[name] = uds
        assert sorted(uds.ugrid.names) == ["mesh2d", "network1d"]
        assert sorted(uds.ugrid.topology) == ["mesh2d", "network1d"]
    got, want = grids["torch"].ugrid, grids["jax"].ugrid
    assert got.bounds == want.bounds and got.total_bounds == want.total_bounds
    renamed = got.rename({"mesh2d": "m"})
    assert sorted(renamed.ugrid.names) == ["m", "network1d"]
    assert_datasets_equal(renamed.ugrid.to_dataset(), want.rename({"mesh2d": "m"}).ugrid.to_dataset())
    for member in ("assign_node_coords", "assign_edge_coords", "assign_face_coords"):
        assert_datasets_equal(getattr(got, member)().obj, getattr(want, member)().obj)
    uda_t = mixed_mesh(xt).create_data_array(np.arange(4.0), "face")
    uda_j = mixed_mesh(xu).create_data_array(np.arange(4.0), "face")
    assert_datasets_equal(uda_t.ugrid.to_dataset(optional_attributes=True),
                          uda_j.ugrid.to_dataset(optional_attributes=True))
    for member in ("assign_node_coords", "assign_edge_coords", "assign_face_coords"):
        t, j = getattr(uda_t.ugrid, member)(), getattr(uda_j.ugrid, member)()
        assert sorted(t.coords) == sorted(j.coords)
        for name in j.coords:
            np.testing.assert_array_equal(t.coords[name].values, np.asarray(j.coords[name].data))
            assert t.coords[name].attrs == j.coords[name].attrs
    assert uda_t.ugrid.rename("r").grid.face_dimension == "r_nFaces" == uda_j.ugrid.rename("r").grid.face_dimension
    with pytest.raises(TypeError, match="face coords"):
        network(xt).create_data_array(np.arange(3.0), "edge").ugrid.assign_face_coords()
    # Coordinate attrs restored by role (projected standard names), and
    # the node coordinates taken from the dataset.
    for name, pkg in PACKAGES.items():
        uds = grids[name]
        ds = uds.ugrid.assign_node_coords().obj
        for grid in uds.grids:
            ds._variables[grid._indexes["node_x"]].attrs = {}
            grid._update_coordinate_attrs(ds)
        grids[name] = ds
    assert_datasets_equal(grids["torch"], grids["jax"])
    assert grids["torch"]["mesh2d_node_x"].attrs == {"standard_name": "projection_x_coordinate"}
    uds = xt.UgridDataset(two_topologies(xt))
    moved = uds.obj.assign_coords(px=("network1d_nNodes", np.arange(4.0)), py=("network1d_nNodes", np.ones(4)))
    xt.UgridDataset(moved, uds.grids).ugrid.set_node_coords("px", "py", topology="network1d")
    np.testing.assert_array_equal(uds.ugrid.topology["network1d"].node_x, np.arange(4.0))
    assert uds.ugrid.topology["network1d"].attrs["node_coordinates"].endswith("px py")


def test_crs_placeholder_without_pyproj():
    from xugrid_tpu_torch.ugrid.crs import CrsPlaceholder, crs_from_attrs, crs_to_attrs

    attrs = {"grid_mapping_name": "transverse_mercator", "epsg": 28992}
    crs = crs_from_attrs(attrs)
    try:
        import pyproj  # noqa: F401
    except ImportError:
        assert isinstance(crs, CrsPlaceholder) and crs == CrsPlaceholder(attrs)
        assert crs_to_attrs(crs) == attrs
    # A grid with a placeholder CRS writes its grid mapping.
    grid = xt.Ugrid2d(*mixed_mesh(xt).node_coordinates.T, -1, mixed_mesh(xt).face_node_connectivity,
                      crs=CrsPlaceholder(attrs))
    ds = grid.to_dataset()
    assert ds["mesh2d_crs"].attrs == attrs and ds["mesh2d_face_nodes"].attrs["grid_mapping"] == "mesh2d_crs"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        back = xt.Ugrid2d.from_dataset(ds)
    assert back.crs == CrsPlaceholder(attrs)
