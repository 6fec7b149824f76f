"""
Facet grids: small-multiple panels over extra (non-UGRID) dimensions.

A shared color scale across panels, per-panel titles from the facet
coordinate, and one figure-level colorbar, over the port's ``xdata``
layer; a torch payload is copied to the host once for the color scale.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch.xdata.variable import to_numpy


class FacetGrid:
    """
    A grid of matplotlib axes, one panel per value of the faceting
    dimension(s) of a UgridDataArray.
    """

    def __init__(
        self,
        uda,
        row: str | None = None,
        col: str | None = None,
        col_wrap: int | None = None,
        sharex: bool = True,
        sharey: bool = True,
        figsize=None,
        size: float = 3.0,
        aspect: float = 1.0,
    ):
        import matplotlib.pyplot as plt

        if row is None and col is None:
            raise ValueError("FacetGrid requires `row` and/or `col`")
        obj = uda.obj if hasattr(uda, "obj") else uda
        for dim in (row, col):
            if dim is not None and dim not in obj.dims:
                raise ValueError(
                    f"Facet dimension {dim!r} not in data dims {obj.dims}"
                )
        self.data = uda
        self.row = row
        self.col = col

        def _facet_values(dim):
            if dim is None:
                return [None]
            coords = getattr(obj, "coords", {})
            if dim in coords:
                return list(np.asarray(coords[dim].data))
            return list(range(obj.sizes[dim]))

        self.row_values = _facet_values(row)
        self.col_values = _facet_values(col)

        if row is None and col_wrap is not None:
            n = len(self.col_values)
            ncol = col_wrap
            nrow = -(-n // col_wrap)
        else:
            nrow = len(self.row_values)
            ncol = len(self.col_values)
        self._col_wrap = col_wrap
        self.nrow, self.ncol = nrow, ncol

        if figsize is None:
            figsize = (ncol * size * aspect, nrow * size)
        self.fig, axes = plt.subplots(
            nrow,
            ncol,
            figsize=figsize,
            sharex=sharex,
            sharey=sharey,
            squeeze=False,
        )
        self.axes = axes
        self.name_dicts = self._make_name_dicts()
        # Hide panels beyond the data when col_wrap leaves a ragged tail.
        for ax, name_dict in zip(self.axes.ravel(), self.name_dicts.ravel()):
            if name_dict is None:
                ax.set_visible(False)

    def _make_name_dicts(self):
        name_dicts = np.full((self.nrow, self.ncol), None, dtype=object)
        if self.row is None and self._col_wrap is not None:
            for k, v in enumerate(self.col_values):
                name_dicts[k // self.ncol, k % self.ncol] = {self.col: k}
        else:
            for i in range(len(self.row_values)):
                for j in range(len(self.col_values)):
                    d = {}
                    if self.row is not None:
                        d[self.row] = i
                    if self.col is not None:
                        d[self.col] = j
                    name_dicts[i, j] = d
        return name_dicts

    def _title(self, name_dict):
        parts = []
        if self.row is not None and self.row in name_dict:
            parts.append(f"{self.row} = {self.row_values[name_dict[self.row]]}")
        if self.col is not None and self.col in name_dict:
            parts.append(f"{self.col} = {self.col_values[name_dict[self.col]]}")
        return ", ".join(str(p) for p in parts)

    def map_ugrid(self, func, add_colorbar: bool = True, **kwargs):
        """
        Call ``func(grid, darray, ax=..., add_colorbar=False, **kwargs)``
        per panel with a shared color scale; add one figure colorbar.
        """
        grid = self.data.grid
        obj = self.data.obj if hasattr(self.data, "obj") else self.data

        # Resolve the shared color scale from the FULL stack up front
        # and pass it into every panel: per-panel _cmap_params then
        # makes identical cmap/levels decisions (post-hoc set_clim
        # cannot unify diverging-cmap choices or contour levels).
        vmin = kwargs.pop("vmin", None)
        vmax = kwargs.pop("vmax", None)
        robust = kwargs.pop("robust", False)
        data = to_numpy(obj.data).astype(np.float64)
        finite = data[np.isfinite(data)]
        if finite.size:
            if vmin is None:
                vmin = float(
                    np.percentile(finite, 2) if robust else finite.min()
                )
            if vmax is None:
                vmax = float(
                    np.percentile(finite, 98) if robust else finite.max()
                )

        artist = None
        for ax, name_dict in zip(self.axes.ravel(), self.name_dicts.ravel()):
            if name_dict is None:
                continue
            sub = obj.isel(**name_dict)
            artist = func(
                grid, sub, ax=ax, add_colorbar=False,
                vmin=vmin, vmax=vmax, **kwargs,
            )
            ax.set_title(self._title(name_dict))
        if add_colorbar and artist is not None:
            self.cbar = self.fig.colorbar(
                artist, ax=self.axes.ravel().tolist(), shrink=0.8
            )
        self._artist = artist
        return self

    def set_titles(self, template: str = "{}") -> None:
        for ax, name_dict in zip(self.axes.ravel(), self.name_dicts.ravel()):
            if name_dict is not None:
                ax.set_title(template.format(self._title(name_dict)))


def plot_facets(accessor, func, row=None, col=None, col_wrap=None, **kwargs):
    """Build a FacetGrid from an accessor and map a plot function."""
    fg = FacetGrid(
        accessor,
        row=row,
        col=col,
        col_wrap=col_wrap,
        figsize=kwargs.pop("figsize", None),
        size=kwargs.pop("size", 3.0),
        aspect=kwargs.pop("aspect", 1.0),
    )
    return fg.map_ugrid(func, **kwargs)
