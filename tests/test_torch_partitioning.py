"""
The port's partitioning and ``merge_partitions`` held on the CPU against
the JAX package's, case by case after ``tests/test_partitioning.py``:
the same seeded inputs through both packages, the labels (with and
without weights, and their errors), ``partition`` and
``partition_by_label`` of a UgridDataArray and a UgridDataset, the
partition round trip, the merge of a single partition, its errors, the
merge of overlapping partitions, two 2D topologies, a 1D dataset and 1D
+ 2D.  Merged grids (node x and y, face-node and edge-node
connectivity, fill value and start index) and merged data are equal,
exactly.  ``unique_rows`` (the native hash, the torch grouping on the
CPU and the numpy plain version) and ``_group_rows_device`` are held to
the JAX functions on float64 and integer rows, signed zeros, NaN
payloads and the empty case.
"""

import numpy as np
import pytest
import torch

import xugrid_tpu as xu
import xugrid_tpu_torch as xt
from xugrid_tpu.core import dedup as jdedup
from xugrid_tpu.ugrid import partitioning as jpart
from xugrid_tpu_torch.core import dedup as tdedup
from xugrid_tpu_torch.ugrid import partitioning as tpart

PKGS = (xu, xt)


def generate_mesh_2d(pkg, nx, ny, name="mesh2d"):
    points = [(x, y) for y in np.linspace(0, ny, ny + 1) for x in np.linspace(0, nx, nx + 1)]
    connectivity = [
        (it + jt * (nx + 1), it + jt * (nx + 1) + 1, it + (jt + 1) * (nx + 1) + 1, it + (jt + 1) * (nx + 1))
        for jt in range(ny)
        for it in range(nx)
    ]
    points = np.array(points, dtype=float)
    return pkg.Ugrid2d(points[:, 0], points[:, 1], -1, np.array(connectivity), name=name)


def generate_mesh_1d(pkg, n, name="mesh1d"):
    points = np.array([(p, p) for p in np.linspace(0, n, n + 1)], dtype=float)
    connectivity = np.array([(it, it + 1) for it in range(n)])
    return pkg.Ugrid1d(points[:, 0], points[:, 1], -1, connectivity, name=name)


def n_core(grid):
    facet = {v: k for k, v in grid.facets.items()}[grid.core_dimension]
    return getattr(grid, f"n_{facet}")


def assert_grids_equal(got, want):
    assert type(got).__name__ == type(want).__name__ and got.name == want.name
    assert got.fill_value == want.fill_value and got.start_index == want.start_index
    assert got.attrs == want.attrs
    np.testing.assert_array_equal(got.node_x, want.node_x)
    np.testing.assert_array_equal(got.node_y, want.node_y)
    np.testing.assert_array_equal(got.edge_node_connectivity, want.edge_node_connectivity)
    if want.topology_dimension == 2:
        np.testing.assert_array_equal(got.face_node_connectivity, want.face_node_connectivity)


def as_host(data):
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def assert_objects_equal(got, want):
    """Two Ugrid wrappers with equal grids and equal variables (names,
    dims, coordinates and values, bit for bit)."""
    assert type(got).__name__ == type(want).__name__
    assert len(got.grids) == len(want.grids)
    for g, w in zip(sorted(got.grids, key=lambda g: g.name), sorted(want.grids, key=lambda g: g.name)):
        assert_grids_equal(g, w)
    gobj, wobj = got.obj, want.obj
    if isinstance(wobj, xu.xdata.DataArray):
        assert gobj.name == wobj.name
        gobj, wobj = gobj.to_dataset(), wobj.to_dataset()
    assert sorted(gobj._variables) == sorted(wobj._variables)
    assert sorted(gobj._coord_names) == sorted(wobj._coord_names)
    for name, var in wobj._variables.items():
        mine = gobj._variables[name]
        assert mine.dims == var.dims, name
        np.testing.assert_array_equal(as_host(mine.data), np.asarray(var.data), err_msg=name)


def test_labels_to_indices():
    labels = np.array([0, 1, 0, 2, 2, 1, 0])
    for got, want in zip(tpart.labels_to_indices(labels), jpart.labels_to_indices(labels)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [4, 16])
def test_hilbert_distance_matches_jax(order):
    xy = np.random.default_rng(3).uniform(-5.0, 20.0, (500, 2))
    want = jpart.hilbert_distance(xy, order)
    np.testing.assert_array_equal(tpart.hilbert_distance(xy, order), want)
    np.testing.assert_array_equal(tpart.hilbert_distance_plain(xy, order), want)


class TestPartition:
    @pytest.fixture(params=["mesh2d", "mesh1d"])
    def grids(self, request):
        if request.param == "mesh2d":
            return {pkg: generate_mesh_2d(pkg, 5, 3) for pkg in PKGS}
        return {pkg: generate_mesh_1d(pkg, 100) for pkg in PKGS}

    @pytest.mark.parametrize("n_part", [1, 2, 3])
    def test_label_partitions(self, grids, n_part):
        want, got = (grids[pkg].label_partitions(n_part=n_part) for pkg in PKGS)
        assert isinstance(got, xt.UgridDataArray) and got.name == "labels"
        assert got.dims == (grids[xt].core_dimension,) and got.grid is grids[xt]
        np.testing.assert_array_equal(got.values, np.asarray(want.values))

    def test_label_partitions_with_weights(self, grids):
        n = n_core(grids[xt])
        half = np.zeros(n, dtype=int)
        half[: n // 2] = 1
        for weights in (np.ones(n, dtype=int), half, np.arange(n)):
            want, got = (grids[pkg].label_partitions(n_part=2, weights=weights) for pkg in PKGS)
            np.testing.assert_array_equal(got.values, np.asarray(want.values))

    @pytest.mark.parametrize(
        "weights, error, match",
        [
            (lambda n: np.ones(n + 1, dtype=int), ValueError, "Wrong shape on weights"),
            (lambda n: np.ones(n, dtype=float), TypeError, "Wrong type on weights"),
            (lambda n: np.full(n, -1, dtype=int), ValueError, "Wrong values on weights"),
        ],
    )
    def test_label_partitions_with_weights__error(self, grids, weights, error, match):
        for pkg in PKGS:
            with pytest.raises(error, match=match):
                grids[pkg].label_partitions(n_part=2, weights=weights(n_core(grids[pkg])))

    @pytest.mark.parametrize("n_part, match", [(0, "n_part must be >= 1"), (10_000, "Cannot partition")])
    def test_label_partitions__n_part_error(self, grids, n_part, match):
        for pkg in PKGS:
            with pytest.raises(ValueError, match=match):
                grids[pkg].label_partitions(n_part=n_part)

    @pytest.mark.parametrize("weighted", [False, True])
    def test_partition(self, grids, weighted):
        n = n_core(grids[xt])
        weights = np.arange(n) % 3 if weighted else None
        want, got = (grids[pkg].partition(n_part=3, weights=weights) for pkg in PKGS)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert isinstance(g, type(grids[xt]))
            assert_grids_equal(g, w)
        assert sum(n_core(p) for p in got) == n


def dataset_partition_setup(pkg):
    grid = generate_mesh_2d(pkg, 4, 4)
    ds = pkg.xdata.Dataset()
    ds["face_z"] = pkg.xdata.DataArray(np.arange(grid.n_face, dtype=float), dims=(grid.face_dimension,))
    ds["node_z"] = pkg.xdata.DataArray(np.arange(grid.n_node, dtype=float), dims=(grid.node_dimension,))
    ds["edge_z"] = pkg.xdata.DataArray(np.arange(grid.n_edge, dtype=float), dims=(grid.edge_dimension,))
    # Variables without a UGRID dimension must pass through merges.
    ds["timeseries"] = pkg.xdata.DataArray(np.arange(3.0), dims=("time",))
    ds["scalar"] = pkg.xdata.DataArray(np.array(1.23))
    return grid, pkg.UgridDataset(ds, grids=[grid])


class TestDatasetPartition:
    @pytest.fixture(autouse=True)
    def setup(self):
        self.grid, self.uds = {}, {}
        for pkg in PKGS:
            self.grid[pkg], self.uds[pkg] = dataset_partition_setup(pkg)

    def test_partition_by_label__errors(self):
        for pkg in PKGS:
            grid, uds = self.grid[pkg], self.uds[pkg]
            with pytest.raises(TypeError, match="labels must be a UgridDataArray"):
                uds.ugrid.partition_by_label(np.zeros(grid.n_face, dtype=int))
            float_labels = pkg.UgridDataArray(
                pkg.xdata.DataArray(np.zeros(grid.n_face), dims=(grid.face_dimension,)), grid
            )
            with pytest.raises(TypeError, match="integer dtype"):
                uds.ugrid.partition_by_label(float_labels)
            node_labels = pkg.UgridDataArray(
                pkg.xdata.DataArray(np.zeros(grid.n_node, dtype=int), dims=(grid.node_dimension,)), grid
            )
            with pytest.raises(ValueError, match="Can only partition"):
                uds.ugrid.partition_by_label(node_labels)
            other = generate_mesh_2d(pkg, 4, 4).label_partitions(2)
            with pytest.raises(ValueError, match="grid of labels does not match"):
                uds.ugrid.partition_by_label(other)

    def test_partition_by_label__dataset(self):
        parts = {}
        for pkg in PKGS:
            labels = self.grid[pkg].label_partitions(n_part=4)
            parts[pkg] = self.uds[pkg].ugrid.partition_by_label(labels)
        assert len(parts[xt]) == 4
        for got, want in zip(parts[xt], parts[xu]):
            assert isinstance(got, xt.UgridDataset)
            assert {"face_z", "node_z", "edge_z", "timeseries", "scalar"} <= set(got.data_vars)
            assert_objects_equal(got, want)

    def test_partition_by_label__dataarray(self):
        parts = {}
        for pkg in PKGS:
            labels = self.grid[pkg].label_partitions(n_part=4)
            parts[pkg] = self.uds[pkg]["face_z"].ugrid.partition_by_label(labels)
        assert sum(part.size for part in parts[xt]) == self.grid[xt].n_face
        for got, want in zip(parts[xt], parts[xu]):
            assert isinstance(got, xt.UgridDataArray) and got.name == "face_z"
            assert_objects_equal(got, want)

    def test_partition_roundtrip(self):
        merged = {pkg: pkg.merge_partitions(self.uds[pkg].ugrid.partition(n_part=4)) for pkg in PKGS}
        assert isinstance(merged[xt], xt.UgridDataset)
        grid = merged[xt].grids[0]
        assert (grid.n_face, grid.n_node, grid.n_edge) == (self.grid[xt].n_face, self.grid[xt].n_node, self.grid[xt].n_edge)
        assert_objects_equal(merged[xt], merged[xu])
        np.testing.assert_array_equal(merged[xt]["timeseries"].values, np.arange(3.0))
        assert float(merged[xt]["scalar"].values) == pytest.approx(1.23)

    def test_partition_roundtrip__tensor_payload(self):
        """Tensor payloads stay tensors through the partition, the data
        selection and the merge, with the numpy payloads' values."""
        uds = self.uds[xt]
        on_tensor = uds.obj.copy(deep=False)
        for name in ("face_z", "node_z", "edge_z"):
            on_tensor[name] = (uds.obj[name].dims, torch.from_numpy(uds.obj[name].values))
        parts = xt.UgridDataset(on_tensor, uds.grids).ugrid.partition(n_part=4)
        assert all(isinstance(p.obj["node_z"].data, torch.Tensor) for p in parts)
        merged = xt.merge_partitions(parts)
        want = xu.merge_partitions(self.uds[xu].ugrid.partition(n_part=4))
        for name in ("face_z", "node_z", "edge_z"):
            assert isinstance(merged.obj[name].data, torch.Tensor)
        assert_objects_equal(merged, want)

    def test_merge_partition_single(self):
        assert xt.merge_partitions([self.uds[xt]]) is self.uds[xt]

    def test_merge_partitions__errors(self):
        for pkg in PKGS:
            grid, uds = self.grid[pkg], self.uds[pkg]
            with pytest.raises(ValueError, match="zero partitions"):
                pkg.merge_partitions([])
            parts = uds.ugrid.partition(n_part=2)
            with pytest.raises(TypeError, match="Expected UgridDataArray or UgridDataset"):
                pkg.merge_partitions([parts[0], parts[1]["face_z"]])
            with pytest.raises(TypeError, match="Expected UgridDataArray or UgridDataset"):
                pkg.merge_partitions([uds.obj, uds.obj])
            other = pkg.UgridDataset(grids=[generate_mesh_1d(pkg, 3, name=grid.name)])
            with pytest.raises(TypeError, match="same type"):
                pkg.merge_partitions([uds, other])
            bad = pkg.xdata.Dataset()
            part_grid = parts[1].grids[0]
            bad["face_z"] = pkg.xdata.DataArray(
                np.zeros((2, part_grid.n_face)), dims=("layer", part_grid.face_dimension)
            )
            with pytest.raises(ValueError, match="do not match across partitions"):
                pkg.merge_partitions([parts[0], pkg.UgridDataset(bad, grids=[part_grid])])

    def test_merge_partitions_no_duplicates(self):
        merged = {}
        for pkg in PKGS:
            face_dim = self.grid[pkg].face_dimension
            p1 = self.uds[pkg].isel({face_dim: np.arange(0, 10)})
            p2 = self.uds[pkg].isel({face_dim: np.arange(6, 16)})
            merged[pkg] = pkg.merge_partitions([p1, p2])
        grid = merged[xt].grids[0]
        assert grid.n_face == self.grid[xt].n_face and grid.n_node == self.grid[xt].n_node
        np.testing.assert_array_equal(np.sort(merged[xt]["face_z"].values), np.arange(self.grid[xt].n_face, dtype=float))
        assert_objects_equal(merged[xt], merged[xu])

    def test_merge_dataarray_partitions(self):
        merged = {pkg: pkg.merge_partitions(self.uds[pkg]["face_z"].ugrid.partition(n_part=3)) for pkg in PKGS}
        assert isinstance(merged[xt], xt.UgridDataset)
        assert_objects_equal(merged[xt], merged[xu])

    def test_label_partitions_accessor_weights(self):
        """The array's integer values act as the weights; a tensor
        payload gives the labels of its host copy."""
        labels = {}
        for pkg in PKGS:
            grid = self.grid[pkg]
            weights = pkg.UgridDataArray(
                pkg.xdata.DataArray(np.arange(grid.n_face) % 4, dims=(grid.face_dimension,)), grid
            )
            labels[pkg] = weights.ugrid.label_partitions(n_part=3)
        np.testing.assert_array_equal(labels[xt].values, np.asarray(labels[xu].values))
        grid = self.grid[xt]
        on_tensor = xt.UgridDataArray(
            xt.xdata.DataArray(torch.arange(grid.n_face) % 4, dims=(grid.face_dimension,)), grid
        )
        np.testing.assert_array_equal(on_tensor.ugrid.label_partitions(n_part=3).values, labels[xt].values)
        with pytest.raises(ValueError, match="core-dimension"):
            self.uds[xt]["node_z"].ugrid.label_partitions(n_part=2)


def multi_2d_setup(pkg):
    grid_a = generate_mesh_2d(pkg, 2, 3, "first")
    grid_b = generate_mesh_2d(pkg, 4, 5, "second")
    partitions = []
    for part_a, part_b in zip(grid_a.partition(n_part=2), grid_b.partition(n_part=2)):
        ds = pkg.xdata.Dataset()
        ds["a"] = pkg.xdata.DataArray(np.ones(part_a.n_face), dims=(part_a.face_dimension,))
        ds["b"] = pkg.xdata.DataArray(np.full(part_b.n_face, 2.0), dims=(part_b.face_dimension,))
        partitions.append(pkg.UgridDataset(ds, grids=[part_a, part_b]))
    return grid_a, grid_b, partitions


def test_multi_topology_2d_merge_partitions():
    merged = {pkg: pkg.merge_partitions(multi_2d_setup(pkg)[2]) for pkg in PKGS}
    by_name = {g.name: g for g in merged[xt].grids}
    assert by_name["first"].n_face == 6 and by_name["second"].n_face == 20
    assert_objects_equal(merged[xt], merged[xu])


def test_multi_topology_2d_merge_partitions__unique_grid_per_partition():
    merged = {}
    for pkg in PKGS:
        grid_a, grid_b, _ = multi_2d_setup(pkg)
        ds_a = pkg.xdata.Dataset()
        ds_a["a"] = pkg.xdata.DataArray(np.ones(grid_a.n_face), dims=(grid_a.face_dimension,))
        ds_b = pkg.xdata.Dataset()
        ds_b["b"] = pkg.xdata.DataArray(np.full(grid_b.n_face, 2.0), dims=(grid_b.face_dimension,))
        merged[pkg] = pkg.merge_partitions([pkg.UgridDataset(ds_a, grids=[grid_a]), pkg.UgridDataset(ds_b, grids=[grid_b])])
    assert len(merged[xt].grids) == 2 and set(merged[xt].data_vars) == {"a", "b"}
    assert_objects_equal(merged[xt], merged[xu])


def test_merge_dataset_1d():
    merged = {}
    for pkg in PKGS:
        grid = generate_mesh_1d(pkg, 10)
        ds = pkg.xdata.Dataset()
        ds["edge_z"] = pkg.xdata.DataArray(np.arange(grid.n_edge, dtype=float), dims=(grid.edge_dimension,))
        ds["node_z"] = pkg.xdata.DataArray(np.arange(grid.n_node, dtype=float), dims=(grid.node_dimension,))
        merged[pkg] = pkg.merge_partitions(pkg.UgridDataset(ds, grids=[grid]).ugrid.partition(n_part=2))
    grid = merged[xt].grids[0]
    assert grid.n_edge == 10 and grid.n_node == 11
    assert_objects_equal(merged[xt], merged[xu])


def multi_1d_2d_setup(pkg):
    partitions = []
    for p1, p2 in zip(generate_mesh_1d(pkg, 10, "network").partition(n_part=2),
                      generate_mesh_2d(pkg, 3, 4, "mesh").partition(n_part=2)):
        ds = pkg.xdata.Dataset()
        ds["edge_z"] = pkg.xdata.DataArray(np.ones(p1.n_edge), dims=(p1.edge_dimension,))
        ds["face_z"] = pkg.xdata.DataArray(np.full(p2.n_face, 2.0), dims=(p2.face_dimension,))
        partitions.append(pkg.UgridDataset(ds, grids=[p1, p2]))
    return partitions


def test_multi_topology_1d_2d_merge_partitions():
    merged = {pkg: pkg.merge_partitions(multi_1d_2d_setup(pkg)) for pkg in PKGS}
    by_name = {g.name: g for g in merged[xt].grids}
    assert isinstance(by_name["network"], xt.Ugrid1d) and isinstance(by_name["mesh"], xt.Ugrid2d)
    assert by_name["network"].n_edge == 10 and by_name["mesh"].n_face == 12
    assert_objects_equal(merged[xt], merged[xu])


def test_multi_topology_1d_2d_merge_partitions__inconsistent_grid_types():
    for pkg in PKGS:
        grid_1d = generate_mesh_1d(pkg, 10, "mesh")
        ds = pkg.xdata.Dataset()
        ds["edge_z"] = pkg.xdata.DataArray(np.ones(grid_1d.n_edge), dims=(grid_1d.edge_dimension,))
        with pytest.raises(TypeError, match="same type"):
            pkg.merge_partitions([multi_1d_2d_setup(pkg)[0], pkg.UgridDataset(ds, grids=[grid_1d])])


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_merge_pads_the_connectivity_dimension(payload):
    """A variable on (face, nmax) of 3 entries, on partitions of
    triangles and of quads: the merged grid holds 4 nodes per face, so
    every partition's variable is padded, NaN for floats and -1 for
    integers, a tensor on its own device."""
    merged = {}
    for pkg in PKGS:
        x = np.array([0.0, 1.0, 2.0, 0.0, 1.0, 2.0])
        y = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 1.0])
        tri = pkg.Ugrid2d(x[[0, 1, 3, 4]], y[[0, 1, 3, 4]], -1, np.array([[0, 1, 3], [0, 3, 2]]))
        quad = pkg.Ugrid2d(x[[1, 2, 4, 5]], y[[1, 2, 4, 5]], -1, np.array([[0, 1, 3, 2]]))
        parts = []
        for grid, offset in ((tri, 0.0), (quad, 10.0)):
            shape = (grid.n_face, 3)
            dims = (grid.face_dimension, grid.max_face_node_dimension)
            values = offset + np.arange(np.prod(shape), dtype=float).reshape(shape)
            ids = np.arange(np.prod(shape)).reshape(shape)
            if pkg is xt and payload == "tensor":
                values, ids = torch.from_numpy(values), torch.from_numpy(ids)
            ds = pkg.xdata.Dataset()
            ds["corner"] = pkg.xdata.DataArray(values, dims=dims)
            ds["corner_id"] = pkg.xdata.DataArray(ids, dims=dims)
            parts.append(pkg.UgridDataset(ds, grids=[grid]))
        merged[pkg] = pkg.merge_partitions(parts)
    got = merged[xt].obj["corner"].data
    assert isinstance(got, torch.Tensor) == (payload == "tensor")
    assert merged[xt].grids[0].n_max_node_per_face == 4 and merged[xt].obj["corner"].shape == (3, 4)
    assert_objects_equal(merged[xt], merged[xu])


@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_pad_dim_matches_jax(payload):
    data = {"f": np.arange(6.0).reshape(2, 3), "i": np.arange(6).reshape(2, 3), "other": np.arange(4.0)}
    want = jpart._pad_dim(
        xu.xdata.Dataset({"f": (("a", "b"), data["f"]), "i": (("a", "b"), data["i"]), "other": (("c",), data["other"])}),
        "b", 2,
    )
    wrap = torch.from_numpy if payload == "tensor" else np.asarray
    got = tpart._pad_dim(
        xt.xdata.Dataset({k: (dims, wrap(data[k])) for k, dims in (("f", ("a", "b")), ("i", ("a", "b")), ("other", ("c",)))}),
        "b", 2,
    )
    for name in data:
        assert isinstance(got._variables[name].data, torch.Tensor) == (payload == "tensor")
        assert got._variables[name].dims == want._variables[name].dims
        np.testing.assert_array_equal(as_host(got._variables[name].data), np.asarray(want._variables[name].data))


# -- unique_rows and the grouping ---------------------------------------------------
def nan_payload_rows():
    """Signed zeros and NaNs of two payloads: bytewise, -0.0 and 0.0
    differ, and so do the NaNs."""
    other_nan = np.array([0x7FF8000000000001], dtype=np.uint64).view(np.float64)[0]
    return np.array(
        [[0.0, 1.0], [-0.0, 1.0], [np.nan, 2.0], [np.nan, 2.0], [other_nan, 2.0], [0.0, 1.0], [-0.0, 1.0]]
    )


def row_cases():
    rng = np.random.default_rng(9)
    base = rng.normal(size=(200, 2))
    return {
        "int64": rng.integers(0, 50, (3000, 3)).astype(np.int64),
        "int32": rng.integers(-4, 4, (2000, 4)).astype(np.int32),
        "float64": base[rng.integers(0, 200, 5000)],
        "uint16": rng.integers(0, 3, (500, 3)).astype(np.uint16),
        "nan_payloads": nan_payload_rows(),
        "single": np.array([[7, 8]]),
        "empty": np.zeros((0, 2)),
    }


CASES = row_cases()


@pytest.mark.parametrize("name", list(CASES))
def test_unique_rows_matches_jax(name, monkeypatch):
    rows = CASES[name]
    monkeypatch.setenv("XUGRID_TPU_DEDUP", "host")
    want_index, want_inverse = jdedup.unique_rows(rows)
    for got_index, got_inverse in (
        tdedup.unique_rows(rows),
        tdedup.unique_rows(rows, device="cpu"),
        tdedup.unique_rows_plain(rows),
    ):
        assert got_index.dtype == np.int64 and got_inverse.dtype == np.int64
        np.testing.assert_array_equal(got_index, want_index)
        np.testing.assert_array_equal(got_inverse, want_inverse)
    if len(rows):
        np.testing.assert_array_equal(rows[want_index][want_inverse].view(np.uint8), rows.view(np.uint8))
    if name == "nan_payloads":
        np.testing.assert_array_equal(want_index, [0, 1, 2, 4])


@pytest.mark.parametrize("name", [n for n in CASES if n != "empty"])
def test_group_rows_device_matches_jax(name):
    cols = jdedup._to_u32_columns(CASES[name])
    np.testing.assert_array_equal(tdedup._to_u32_columns(CASES[name]), cols)
    want_inverse, want_rep, want_n = jdedup._group_rows_device(cols, cols.shape[1])
    inverse, rep, n_unique = tdedup._group_rows_device(torch.from_numpy(cols.astype(np.int64)))
    assert n_unique == int(want_n)
    np.testing.assert_array_equal(inverse.numpy(), np.asarray(want_inverse))
    np.testing.assert_array_equal(rep.numpy(), np.asarray(want_rep)[:n_unique])


def test_unique_rows_device_matches_jax_device(monkeypatch):
    """The JAX package's forced device path against the port's torch
    grouping, on more rows than the JAX path's bucket size."""
    rows = np.random.default_rng(10).integers(0, 300, (70_000, 2)).astype(np.int64)
    monkeypatch.setenv("XUGRID_TPU_DEDUP", "device")
    want_index, want_inverse = jdedup.unique_rows(rows)
    got_index, got_inverse = tdedup.unique_rows(rows, device="cpu")
    np.testing.assert_array_equal(got_index, want_index)
    np.testing.assert_array_equal(got_inverse, want_inverse)


def test_merge_connectivity_wider_than_the_native_kernel():
    """Rows of more than 64 entries take the row sort and unique_rows."""
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 3, (40, 70))
    rows[20:] = rows[:20, ::-1]
    slices = (0, 25, 40)
    got, got_indexes = tpart._merge_connectivity(rows.copy(), slices)
    want, want_indexes = jpart._merge_connectivity(rows.copy(), slices)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_indexes, want_indexes):
        np.testing.assert_array_equal(g, w)
