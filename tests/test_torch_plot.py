"""
The port's plotting (``xugrid_tpu_torch/plot``) held on the CPU against
the JAX package's: the same grid and data drawn through both packages,
every function and ``uda.ugrid.plot()`` on face, node and edge data,
with a numpy and a torch payload.  The artists must agree: their arrays
(NaN-equal), collection paths and segments, the contour triangulations'
triangles and the contour levels, the norm's limits, the colormap's
name, the colorbar's ``extend``, and the image with its extent.  Facet
grids (``row=``, ``col=``, ``col_wrap=``) give the same axes shape,
titles and panels.  matplotlib draws with the Agg backend; every figure
is closed after each case.
"""

import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import xugrid_tpu as xu  # noqa: E402
import xugrid_tpu_torch as xt  # noqa: E402
from xugrid_tpu.plot import plot as jax_plot  # noqa: E402
from xugrid_tpu_torch.plot import plot as torch_plot  # noqa: E402

PACKAGES = {"jax": (xu, jax_plot), "torch": (xt, torch_plot)}


def teardown_function(function):
    plt.close("all")


def quad_grid(package, n=3):
    x = np.arange(n + 1.0)
    yy, xx = np.meshgrid(x, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    verts[(verts > 0).all(1) & (verts < n).all(1)] += 0.1
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    nid = lambda a, b: b * (n + 1) + a  # noqa: E731
    faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1).reshape(-1, 4)
    return package.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)


def facet_values(grid, facet, extra=()):
    n = {"face": grid.n_face, "node": grid.n_node, "edge": grid.n_edge}[facet]
    shape = tuple(extra) + (n,)
    return np.sin(np.arange(int(np.prod(shape)), dtype=float)).reshape(shape) * 5.0 + 1.0


def uda_of(name, facet, payload="numpy", extra=(), coords=None):
    package, _ = PACKAGES[name]
    grid = quad_grid(package)
    dims = {"face": grid.face_dimension, "node": grid.node_dimension, "edge": grid.edge_dimension}
    extra_dims = ("layer", "time")[-len(extra):] if extra else ()
    values = facet_values(grid, facet, extra)
    if payload == "torch" and name == "torch":
        values = torch.from_numpy(values)
    da = package.xdata.DataArray(values, dims=extra_dims + (dims[facet],), coords=coords or {}, name="z")
    return package.UgridDataArray(da, grid)


def summary(artist):
    """What the comparison reads of an artist."""
    import matplotlib.colors as mcolors
    from matplotlib.collections import LineCollection

    out = {"type": type(artist).__name__}
    norm = getattr(artist, "norm", None)
    if norm is not None:
        out["norm"] = (type(norm).__name__, norm.vmin, norm.vmax)
        if isinstance(norm, mcolors.BoundaryNorm):
            out["boundaries"] = np.asarray(norm.boundaries)
    cmap = getattr(artist, "cmap", None)
    if cmap is not None:
        out["cmap"] = (cmap.name, cmap.N)
    colorbar = getattr(artist, "colorbar", None)
    if colorbar is not None:
        out["extend"] = colorbar.extend
    if hasattr(artist, "get_array") and artist.get_array() is not None:
        out["array"] = np.ma.filled(np.ma.asarray(artist.get_array(), dtype=float), np.nan)
    if hasattr(artist, "get_paths"):
        out["paths"] = [p.vertices for p in artist.get_paths()]
    if isinstance(artist, LineCollection):
        out["segments"] = artist.get_segments()
    if hasattr(artist, "levels"):
        out["levels"] = np.asarray(artist.levels)
        out["contour_extend"] = artist.extend
    if hasattr(artist, "get_extent"):
        out["extent"] = tuple(artist.get_extent())
    return out


def assert_same(a, b, path="artist"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for key in a:
            assert_same(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)) and not (a and isinstance(a[0], (str, float, int, type(None)))):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{k}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=path)
    else:
        assert a == b, (path, a, b)


def draw_both(draw):
    """``draw(name)`` through each package, each in a fresh figure."""
    out = {}
    for name in PACKAGES:
        out[name] = summary(draw(name))
        plt.close("all")
    assert_same(out["jax"], out["torch"])
    return out["torch"]


FUNCTIONS = {
    "pcolormesh face": ("pcolormesh", "face", {}),
    "pcolormesh levels": ("pcolormesh", "face", {"levels": 5}),
    "pcolormesh level list": ("pcolormesh", "face", {"levels": [0.0, 2.0, 4.0]}),
    "pcolormesh robust": ("pcolormesh", "face", {"robust": True, "add_colorbar": True}),
    "pcolormesh center": ("pcolormesh", "face", {"center": 1.0, "add_colorbar": True}),
    "pcolormesh vmin vmax": ("pcolormesh", "face", {"vmin": 0.0, "vmax": 3.0, "add_colorbar": True}),
    "tripcolor node": ("tripcolor", "node", {"add_colorbar": True}),
    "line edge": ("line", "edge", {"cmap": "viridis"}),
    "scatter face": ("scatter", "face", {}),
    "contour node": ("contour", "node", {"levels": [0.0, 1.5, 3.0]}),
    "contourf node": ("contourf", "node", {"levels": 4}),
    "contourf face": ("contourf", "face", {"location": "face"}),
    "surface node": ("surface", "node", {}),
    "imshow face": ("imshow", "face", {"resolution": 0.5, "add_colorbar": True}),
}


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_functions_draw_the_same_artists(case, payload):
    function, facet, kwargs = FUNCTIONS[case]

    def draw(name):
        uda = uda_of(name, facet, payload)
        _, module = PACKAGES[name]
        return getattr(module, function)(uda.grid, uda.obj, **dict(kwargs))

    got = draw_both(draw)
    if function == "imshow":
        assert got["array"].shape == (6, 6) and np.isfinite(got["array"]).any()


@pytest.mark.parametrize("location", ["node", "face"])
def test_contour_triangulations_equal(location):
    triangulations = []
    for name in PACKAGES:
        uda = uda_of(name, location)
        _, module = PACKAGES[name]
        tri, z = module._contour_triangulation(uda.grid, np.asarray(uda.obj.values), location)
        triangulations.append((tri.x, tri.y, tri.triangles, z))
    for a, b in zip(*triangulations):
        np.testing.assert_array_equal(b, a)


DISPATCH = [
    (facet, method)
    for facet in ("face", "node", "edge")
    for method in ("__call__", "scatter", "contourf", "imshow")
    # imshow rasterizes face data; contours take node or face data.
    if not (method == "imshow" and facet != "face") and not (method == "contourf" and facet == "edge")
]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("facet, method", DISPATCH)
def test_accessor_plot_dispatch(facet, method, payload):
    def draw(name):
        uda = uda_of(name, facet, payload)
        if name == "torch":
            assert isinstance(uda.obj.data, torch.Tensor) == (payload == "torch")
        plot = uda.ugrid.plot
        return plot() if method == "__call__" else getattr(plot, method)()

    got = draw_both(draw)
    assert "array" in got


def test_grid_plot_and_top_level_line():
    draw_both(lambda name: quad_grid(PACKAGES[name][0]).plot())
    draw_both(lambda name: PACKAGES[name][0].plot.line(quad_grid(PACKAGES[name][0])))


FACETS = {
    "col": ({"col": "time"}, (4,)),
    "col_wrap": ({"col": "time", "col_wrap": 3}, (4,)),
    "row and col": ({"row": "layer", "col": "time"}, (2, 3)),
}


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(FACETS))
def test_facet_grids(case, payload):
    kwargs, extra = FACETS[case]
    coords = {"time": np.arange(extra[-1]) * 10.0}
    grids = {}
    for name in PACKAGES:
        fg = uda_of(name, "face", payload, extra, coords).ugrid.plot.pcolormesh(**kwargs)
        grids[name] = (
            fg.axes.shape,
            [ax.get_title() for ax in fg.axes.ravel()],
            [ax.get_visible() for ax in fg.axes.ravel()],
            [summary(ax.collections[0]) for ax in fg.axes.ravel() if ax.collections],
        )
        plt.close("all")
    assert_same(list(grids["jax"]), list(grids["torch"]))
    if case == "col_wrap":
        assert grids["torch"][0] == (2, 3) and grids["torch"][2][-1] is False


def test_facet_grid_needs_the_dimension():
    with pytest.raises(ValueError, match="not in data dims"):
        uda_of("torch", "face").ugrid.plot.pcolormesh(col="time")


def test_cmap_params_equal():
    values = np.linspace(-2.0, 10.0, 9)
    for kwargs in ({"vmin": 2.0, "vmax": 8.0}, {"vmin": -1.0}, {"levels": [1.0, 3.0]}, {"robust": True}):
        want, want_cbar = jax_plot._cmap_params(values, dict(kwargs))
        got, got_cbar = torch_plot._cmap_params(values, dict(kwargs))
        assert got_cbar == want_cbar and got.keys() == want.keys()
        assert_same(summary(plt.cm.ScalarMappable(norm=want.get("norm"), cmap=want.get("cmap"))),
                    summary(plt.cm.ScalarMappable(norm=got.get("norm"), cmap=got.get("cmap"))))
    assert torch_plot._infer_extend(values, 0.0, 5.0) == jax_plot._infer_extend(values, 0.0, 5.0) == "both"


def test_figure_sizing():
    for name in PACKAGES:
        uda = uda_of(name, "face")
        _, module = PACKAGES[name]
        artist = module.pcolormesh(uda.grid, uda.obj, size=4.0, aspect=2.0)
        np.testing.assert_allclose(artist.axes.figure.get_size_inches(), [8.0, 4.0])
        fig, ax = plt.subplots()
        with pytest.raises(ValueError, match="figsize"):
            module.pcolormesh(uda.grid, uda.obj, ax=ax, figsize=(3, 3))
        plt.close("all")
