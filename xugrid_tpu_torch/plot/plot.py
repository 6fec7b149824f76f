"""
Matplotlib plotting of UGRID data (host drawing).

pcolormesh / tripcolor / line / contour(f) / imshow / scatter / surface,
with facet dispatch through ``uda.ugrid.plot`` and facet grids over
extra dims through row=/col= kwargs (plot/facetgrid.py).  matplotlib is
imported inside the functions only.  A torch payload, on any device, is
copied to the host explicitly before it is drawn.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.ugrid.connectivity import close_polygons
from xugrid_tpu_torch.xdata.variable import to_numpy


def _pop_axis_args(kwargs):
    """Extract figure-sizing kwargs (xarray's figsize/size/aspect)."""
    return {
        "figsize": kwargs.pop("figsize", None),
        "size": kwargs.pop("size", None),
        "aspect": kwargs.pop("aspect", None),
    }


def _ensure_ax(ax=None, figsize=None, size=None, aspect=None, **subplot_kws):
    """Create an axis honoring xarray's figsize/size/aspect contract
    (reference: xugrid/plot/utils.py ``get_axis``)."""
    import matplotlib.pyplot as plt

    if ax is not None:
        if figsize is not None or size is not None or aspect is not None:
            raise ValueError(
                "cannot provide figsize/size/aspect together with ax"
            )
        return ax
    if figsize is not None:
        if size is not None:
            raise ValueError("cannot provide both `figsize` and `size`")
    elif size is not None:
        figsize = (size * (aspect if aspect is not None else 1.0), size)
    elif aspect is not None:
        raise ValueError("cannot provide `aspect` without `size`")
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(**subplot_kws)
    return ax


def _unpack(grid_or_accessor, darray):
    """Accept (grid, values) or an accessor-style pair."""
    values = None
    if darray is not None:
        values = to_numpy(darray.data if hasattr(darray, "data") else darray).squeeze()
    return grid_or_accessor, values


def _add_colorbar(ax, artist, add_colorbar, extend=None):
    if add_colorbar:
        cbar_kw = {} if extend is None else {"extend": extend}
        ax.figure.colorbar(artist, ax=ax, **cbar_kw)


def _infer_extend(calc, vmin, vmax):
    below = bool(calc.size) and float(calc.min()) < vmin
    above = bool(calc.size) and float(calc.max()) > vmax
    if below and above:
        return "both"
    if below:
        return "min"
    if above:
        return "max"
    return "neither"


def _discrete_cmap(cmap, levels, extend, divergent):
    """BoundaryNorm + ListedColormap with under/over colors carved from
    the continuous map's ends (xarray's _build_discrete_cmap)."""
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt

    if cmap is None:
        cmap = "RdBu_r" if divergent else "viridis"
    base = plt.get_cmap(cmap) if isinstance(cmap, str) else cmap
    extra = {"neither": 0, "min": 1, "max": 1, "both": 2}[extend]
    n_colors = len(levels) - 1 + extra
    colors = base(np.linspace(0.0, 1.0, max(n_colors, 1)))
    under = over = None
    if extend in ("min", "both"):
        under, colors = colors[0], colors[1:]
    if extend in ("max", "both"):
        over, colors = colors[-1], colors[:-1]
    new_cmap = mcolors.ListedColormap(colors, name="xugrid_discrete")
    if under is not None:
        new_cmap.set_under(under)
    if over is not None:
        new_cmap.set_over(over)
    norm = mcolors.BoundaryNorm(levels, ncolors=new_cmap.N)
    return new_cmap, norm


def _cmap_params(values, kwargs, contour=False):
    """
    Resolve xarray-style colormap keywords (vmin/vmax/robust/center/
    norm/levels/extend) into a Normalize + cmap pair every matplotlib
    artist accepts (PolyCollection/LineCollection reject raw vmin=/
    vmax=).  Returns ``(kwargs, colorbar_kwargs)``.

    Mirrors the reference's _process_cmap_cbar_kwargs behavior
    (xugrid/plot/utils.py): robust uses the 2-98 percentile range; data
    straddling zero (or an explicit ``center``) selects symmetric
    limits with a diverging default colormap; ``levels`` (an int for
    MaxNLocator ticks, or explicit boundaries) builds a discrete
    BoundaryNorm colormap whose under/over colors honor ``extend``
    (inferred from the data range when not given).
    """
    vmin = kwargs.pop("vmin", None)
    vmax = kwargs.pop("vmax", None)
    robust = kwargs.pop("robust", False)
    center = kwargs.pop("center", None)
    norm = kwargs.pop("norm", None)
    levels = kwargs.pop("levels", None)
    extend = kwargs.pop("extend", None)
    if values is None:
        return kwargs, {}
    if norm is not None:
        kwargs["norm"] = norm
        return kwargs, {"extend": extend} if extend else {}
    calc = np.asarray(values, dtype=float).ravel()
    calc = calc[np.isfinite(calc)]
    if calc.size == 0:
        return kwargs, {}
    computed_vmin = vmin is None
    computed_vmax = vmax is None
    if computed_vmin:
        vmin = float(np.percentile(calc, 2) if robust else calc.min())
    if computed_vmax:
        vmax = float(np.percentile(calc, 98) if robust else calc.max())
    divergent = center is not None
    if center is None and computed_vmin and computed_vmax and vmin < 0 < vmax:
        center = 0.0
        divergent = True
    if divergent:
        lim = max(abs(vmax - center), abs(vmin - center))
        vmin, vmax = center - lim, center + lim
        if levels is None:
            kwargs.setdefault("cmap", "RdBu_r")
    import matplotlib.colors

    if levels is not None:
        if isinstance(levels, int):
            from matplotlib.ticker import MaxNLocator

            levels = MaxNLocator(levels).tick_values(vmin, vmax)
        levels = np.asarray(levels, dtype=float)
        if extend is None:
            extend = _infer_extend(calc, levels.min(), levels.max())
        if contour:
            # matplotlib's (tri)contour machinery owns level placement
            # and extension; hand the resolved boundaries straight over.
            kwargs["levels"] = levels
            kwargs["extend"] = extend
            return kwargs, {}
        cmap, bnorm = _discrete_cmap(
            kwargs.pop("cmap", None), levels, extend, divergent
        )
        kwargs["cmap"] = cmap
        kwargs["norm"] = bnorm
        return kwargs, {"extend": extend}
    if contour and extend is not None:
        kwargs["extend"] = extend
        extend = None
    kwargs["norm"] = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)
    if extend is None:
        extend = _infer_extend(calc, vmin, vmax)
    return kwargs, {"extend": extend} if extend != "neither" else {}


def line(grid, darray=None, ax=None, add_colorbar: bool = False, **kwargs):
    """Plot the edges of the grid as a LineCollection; optional edge
    values as colors."""
    from matplotlib.collections import LineCollection

    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    segments = grid.node_coordinates[grid.edge_node_connectivity]
    kwargs.setdefault("colors", "#000033" if values is None else None)
    cbar_kw = {}
    if values is not None:
        kwargs.pop("colors")
        kwargs, cbar_kw = _cmap_params(values, kwargs)
    collection = LineCollection(segments, **kwargs)
    if values is not None:
        collection.set_array(values)
    ax.add_collection(collection)
    ax.autoscale_view()
    if values is not None:
        _add_colorbar(ax, collection, add_colorbar, **cbar_kw)
    return collection


def scatter(grid, darray=None, dim=None, ax=None, add_colorbar: bool = False, **kwargs):
    """Scatter the coordinates of a facet, colored by its values."""
    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    dim = dim or grid.core_dimension
    coords = grid.get_coordinates(dim)
    kwargs, cbar_kw = _cmap_params(values, kwargs)
    artist = ax.scatter(coords[:, 0], coords[:, 1], c=values, **kwargs)
    if values is not None:
        _add_colorbar(ax, artist, add_colorbar, **cbar_kw)
    return artist


def pcolormesh(grid, darray=None, ax=None, add_colorbar: bool = False, **kwargs):
    """Draw face values as filled polygons (PolyCollection)."""
    from matplotlib.collections import PolyCollection

    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    closed, _ = close_polygons(grid.face_node_connectivity)
    vertices = grid.node_coordinates[closed]
    kwargs, cbar_kw = _cmap_params(values, kwargs)
    collection = PolyCollection(vertices, **kwargs)
    if values is not None:
        collection.set_array(values)
    ax.add_collection(collection)
    ax.autoscale_view()
    if values is not None:
        _add_colorbar(ax, collection, add_colorbar, **cbar_kw)
    return collection


def tripcolor(grid, darray=None, ax=None, add_colorbar: bool = False, **kwargs):
    """Draw node values on the grid triangulation."""
    import matplotlib.tri

    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    (node_x, node_y, triangles), _ = grid.triangulation
    triangulation = matplotlib.tri.Triangulation(node_x, node_y, triangles)
    kwargs, cbar_kw = _cmap_params(values, kwargs)
    artist = ax.tripcolor(triangulation, values, **kwargs)
    _add_colorbar(ax, artist, add_colorbar, **cbar_kw)
    return artist


def _contour_triangulation(grid, values, location):
    import matplotlib.tri

    if location == "node":
        (node_x, node_y, triangles), _ = grid.triangulation
        z = values
    else:  # face values -> centroid triangulation
        (node_x, node_y, triangles), face_index = grid.centroid_triangulation
        z = values[face_index]
    return matplotlib.tri.Triangulation(node_x, node_y, triangles), z


def contour(grid, darray=None, ax=None, location="node", add_colorbar=False, **kwargs):
    """Contour lines of node or face data."""
    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    triangulation, z = _contour_triangulation(grid, values, location)
    kwargs, cbar_kw = _cmap_params(z, kwargs, contour=True)
    artist = ax.tricontour(triangulation, z, **kwargs)
    _add_colorbar(ax, artist, add_colorbar, **cbar_kw)
    return artist


def contourf(grid, darray=None, ax=None, location="node", add_colorbar=False, **kwargs):
    """Filled contours of node or face data."""
    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    triangulation, z = _contour_triangulation(grid, values, location)
    kwargs, cbar_kw = _cmap_params(z, kwargs, contour=True)
    artist = ax.tricontourf(triangulation, z, **kwargs)
    _add_colorbar(ax, artist, add_colorbar, **cbar_kw)
    return artist


def surface(grid, darray=None, ax=None, location="node", add_colorbar=False, **kwargs):
    """3D triangular surface plot."""
    import matplotlib.pyplot as plt

    grid, values = _unpack(grid, darray)
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    triangulation, z = _contour_triangulation(grid, values, location)
    artist = ax.plot_trisurf(triangulation, z, **kwargs)
    _add_colorbar(ax, artist, add_colorbar)
    return artist


def imshow(
    grid,
    darray=None,
    ax=None,
    resolution=None,
    add_colorbar: bool = False,
    **kwargs,
):
    """Rasterize face data and draw with imshow (default >= 500 px)."""
    grid, values = _unpack(grid, darray)
    ax = _ensure_ax(ax, **_pop_axis_args(kwargs))
    xmin, ymin, xmax, ymax = grid.bounds
    if resolution is None:
        resolution = max(xmax - xmin, ymax - ymin) / 500
    x, y, index = grid.rasterize(resolution)
    img = np.where(index != -1, values[np.maximum(index, 0)], np.nan)
    kwargs.setdefault("origin", "upper")
    # Extent spans the OUTER cell edges; center-to-center would shift
    # the raster by half a pixel against mesh overlays.
    d = abs(resolution)
    kwargs.setdefault(
        "extent",
        (x.min() - 0.5 * d, x.max() + 0.5 * d,
         y.min() - 0.5 * d, y.max() + 0.5 * d),
    )
    kwargs, cbar_kw = _cmap_params(img, kwargs)
    artist = ax.imshow(img, **kwargs)
    _add_colorbar(ax, artist, add_colorbar, **cbar_kw)
    return artist


class _PlotMethods:
    """``uda.ugrid.plot``: dispatch by the data's facet."""

    def __init__(self, accessor):
        self._accessor = accessor

    def _dispatch(self):
        grid = self._accessor.grid
        obj = self._accessor.obj
        dims = set(obj.dims)
        if grid.core_dimension in dims and grid.topology_dimension == 2:
            return "face"
        if grid.node_dimension in dims:
            return "node"
        if grid.edge_dimension in dims:
            return "edge"
        raise ValueError(
            f"Data dimensions {obj.dims} do not include a UGRID dimension "
            f"of grid {grid.name}"
        )

    def __call__(self, **kwargs):
        facet = self._dispatch()
        if facet == "face":
            return self.pcolormesh(**kwargs)
        elif facet == "node":
            return self.tripcolor(**kwargs)
        return self.line(**kwargs)

    def _grid_and_data(self):
        return self._accessor.grid, self._accessor.obj

    def _maybe_facet(self, func, kwargs):
        """row=/col= kwargs dispatch to a FacetGrid of small multiples."""
        row = kwargs.pop("row", None)
        col = kwargs.pop("col", None)
        col_wrap = kwargs.pop("col_wrap", None)
        if row is None and col is None:
            return None
        from xugrid_tpu_torch.plot.facetgrid import plot_facets

        return plot_facets(
            self._accessor, func, row=row, col=col, col_wrap=col_wrap, **kwargs
        )

    def pcolormesh(self, **kwargs):
        fg = self._maybe_facet(pcolormesh, kwargs)
        if fg is not None:
            return fg
        grid, da = self._grid_and_data()
        return pcolormesh(grid, da, **kwargs)

    def tripcolor(self, **kwargs):
        fg = self._maybe_facet(tripcolor, kwargs)
        if fg is not None:
            return fg
        grid, da = self._grid_and_data()
        return tripcolor(grid, da, **kwargs)

    def line(self, **kwargs):
        grid, da = self._grid_and_data()
        facet = self._dispatch()
        if facet == "edge":
            fg = self._maybe_facet(line, kwargs)
            if fg is not None:
                return fg
        return line(grid, da if facet == "edge" else None, **kwargs)

    def scatter(self, **kwargs):
        grid, da = self._grid_and_data()
        dims = set(da.dims)
        dim = next(iter(grid.dims & dims))
        return scatter(grid, da, dim=dim, **kwargs)

    def contour(self, **kwargs):
        facet = self._dispatch()
        kwargs.setdefault("location", "face" if facet == "face" else "node")
        fg = self._maybe_facet(contour, kwargs)
        if fg is not None:
            return fg
        grid, da = self._grid_and_data()
        return contour(grid, da, **kwargs)

    def contourf(self, **kwargs):
        facet = self._dispatch()
        kwargs.setdefault("location", "face" if facet == "face" else "node")
        fg = self._maybe_facet(contourf, kwargs)
        if fg is not None:
            return fg
        grid, da = self._grid_and_data()
        return contourf(grid, da, **kwargs)

    def surface(self, **kwargs):
        grid, da = self._grid_and_data()
        facet = self._dispatch()
        location = "face" if facet == "face" else "node"
        return surface(grid, da, location=location, **kwargs)

    def imshow(self, **kwargs):
        fg = self._maybe_facet(imshow, kwargs)
        if fg is not None:
            return fg
        grid, da = self._grid_and_data()
        return imshow(grid, da, **kwargs)
