"""
Structured (raster) grid adapters of the regridders (host, numpy).

Copied from ``xugrid_tpu/regrid/structured.py``: 1D and 2D grids,
voxels (``StructuredGrid3d``) and layered models with per-column layer
bounds (``ExplicitStructuredGrid3d``).  Cell bounds come from a
``{x}bounds`` coordinate, a ``d{x}`` spacing or equidistant midpoints;
descending axes are flipped internally and their indices flipped back on
output; overlap by interval joins, centroid location by searchsorted
containment, (bi/tri)linear weights by neighbouring centroid pairs, the
per-axis joins combined by outer products (``utils.broadcast``); the
layers of a layered model by batched interval joins per column pair
(``overlap_1d.overlap_1d_nd``).  Every join returns ``(source_index,
target_index, weights)`` sorted by target, linear indices row-major over
(z, y, x) for the 3D grids; ``core.sparse`` turns them into the
``PaddedCSR`` that ``regrid.apply.apply_weights`` takes.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.regrid.overlap_1d import overlap_1d, overlap_1d_nd
from xugrid_tpu_torch.regrid.utils import broadcast
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d
from xugrid_tpu_torch.utils.profiling import timed


def _sorted(source_index, target_index, weights):
    sorter = np.argsort(target_index, kind="stable")
    return source_index[sorter], target_index[sorter], weights[sorter]


class StructuredGrid1d:
    """
    One axis of a structured grid, defined by cell bounds.

    Bounds come from an explicit ``{name}bounds`` coordinate, a ``d{name}``
    spacing coordinate, or equidistant inference from midpoints.
    Decreasing coordinates are flipped internally and indexes flipped back
    on output.
    """

    def __init__(self, obj, name: str):
        bounds_name = f"{name}bounds"
        size_name = f"d{name}"

        if name not in obj.coords:
            raise ValueError(f"Coordinate {name!r} not present in object.")
        midpoints_raw = np.asarray(obj[name].data, dtype=np.float64)
        diffs = np.diff(midpoints_raw)
        if (diffs < 0).all() or (len(diffs) and (diffs <= 0).all()):
            midpoints = midpoints_raw[::-1]
            flipped = True
        elif (diffs >= 0).all():
            midpoints = midpoints_raw
            flipped = False
        else:
            raise ValueError(f"{name} is not monotonic")

        coords = obj.coords
        if bounds_name in coords:
            bounds = np.asarray(obj[bounds_name].data, dtype=np.float64)
            if flipped:
                bounds = bounds[::-1]
                bounds = np.sort(bounds, axis=1)
            size = bounds[:, 1] - bounds[:, 0]
        else:
            if size_name in coords:
                size = np.asarray(obj[size_name].data, dtype=np.float64)
                if size.ndim == 1 and flipped:
                    size = size[::-1]
            else:
                size = np.diff(midpoints)
                if len(size) == 0:
                    raise ValueError(
                        f"Cannot infer cell size along {name} from a single "
                        f"midpoint; provide {bounds_name} or {size_name}."
                    )
                atol = 1.0e-4 * size[0]
                if not np.allclose(size, size[0], atol=atol):
                    raise ValueError(
                        f"DataArray has to be equidistant along {name}, or "
                        f'explicit bounds must be given as "{bounds_name}", '
                        f'or cellsizes as "{size_name}"'
                    )
                size = np.full_like(midpoints, size[0])
            abs_size = np.broadcast_to(np.abs(size), midpoints.shape)
            bounds = np.column_stack((midpoints - 0.5 * abs_size, midpoints + 0.5 * abs_size))
            size = abs_size

        self.name = name
        self.midpoints = midpoints
        self.bounds = bounds
        self.flipped = flipped
        self.dname = size_name
        self.dvalue = np.asarray(size)
        self.index = midpoints_raw

    @property
    def coords(self) -> dict:
        coords = {self.name: self.index}
        if self.dvalue.ndim == 0:
            coords[self.dname] = self.dvalue
        else:
            dvalue = self.dvalue[::-1] if self.flipped else self.dvalue
            coords[self.dname] = (self.name, dvalue)
        return coords

    @property
    def ndim(self) -> int:
        return 1

    @property
    def dims(self) -> Tuple[str]:
        return (self.name,)

    @property
    def size(self) -> int:
        return len(self.bounds)

    @property
    def length(self) -> np.ndarray:
        # diff gives (n, 1): take the column, which keeps a single cell 1-D.
        return np.abs(np.diff(self.bounds, axis=1))[:, 0]

    @property
    def directional_bounds(self) -> np.ndarray:
        """The bounds in the coordinate's own order."""
        if self.flipped:
            return self.bounds[::-1, :].copy()
        return self.bounds

    def flip_if_needed(self, index: np.ndarray) -> np.ndarray:
        if self.flipped:
            return self.size - index - 1
        return index

    # -- joins ----------------------------------------------------------------
    def overlap(self, other: "StructuredGrid1d", relative: bool):
        """Interval-overlap join; weights are overlap lengths, relative to
        the source cell length with ``relative``."""
        source_index, target_index, weights = overlap_1d(self.bounds, other.bounds)
        if relative:
            weights = weights / self.length[source_index]
        source_index = self.flip_if_needed(source_index)
        target_index = other.flip_if_needed(target_index)
        return _sorted(source_index, target_index, weights)

    def locate_centroids(self, other: "StructuredGrid1d", tolerance=None):
        """Containment join of target midpoints in source cells."""
        source, target = self._containment(other)
        return _sorted(source, target, np.ones(len(source), dtype=np.float64))

    def _containment(self, other: "StructuredGrid1d"):
        mid = other.midpoints
        inside = (mid > self.bounds[0, 0]) & (mid < self.bounds[-1, 1])
        cell = np.searchsorted(self.bounds[:, 1], mid, side="left")
        cell = np.clip(cell, 0, self.size - 1)
        contains = inside & (mid >= self.bounds[cell, 0]) & (mid <= self.bounds[cell, 1])
        target = np.flatnonzero(contains)
        source = cell[contains]
        return self.flip_if_needed(source), other.flip_if_needed(target)

    def linear_weights(self, other: "StructuredGrid1d"):
        """Pairs of neighbouring source centroids with linear weights for
        each contained target midpoint.  Raises on weights outside [0, 1]."""
        if self.midpoints.size < 2:
            raise ValueError(
                f"Coordinate {self.name} has size: {self.midpoints.size}. "
                "At least two points are required for interpolation."
            )
        source, target = self._containment(other)
        # Work in ascending (unflipped) positions; the flip is involutive.
        src_pos = self.flip_if_needed(source)
        tgt_pos = other.flip_if_needed(target)

        t_mid = other.midpoints[tgt_pos]
        s_mid = self.midpoints[src_pos]
        neighbor = np.where(t_mid <= s_mid, -1, 1)
        neighbor_pos = np.clip(src_pos + neighbor, 0, self.midpoints.size - 1)
        neighbor = neighbor_pos - src_pos

        total = self.midpoints[neighbor_pos] - s_mid
        total[total == 0] = 1.0
        w_self = 1.0 - (t_mid - s_mid) / total
        w_self[neighbor == 0] = 0.0
        if np.any((w_self < 0.0) | (w_self > 1.0)):
            raise ValueError(f"Computed invalid weights for dimension: {self.name}")

        source_index = np.column_stack((src_pos, neighbor_pos)).ravel()
        target_index = np.repeat(tgt_pos, 2)
        weights = np.column_stack((w_self, 1.0 - w_self)).ravel()
        valid = (source_index >= 0) & (source_index <= self.size - 1)
        source_index = self.flip_if_needed(source_index[valid])
        target_index = other.flip_if_needed(target_index[valid])
        return _sorted(source_index, target_index, weights[valid])


    def to_dataset(self, name: str):
        """The axis as ``{name}_{axis}`` midpoints and ``{name}_{axis}bounds``
        directional bounds, both coordinates."""
        export_name = name + "_" + self.name
        ds = xdata.Dataset()
        ds[export_name] = ((export_name,), self.index)
        ds._coord_names.add(export_name)
        ds[export_name + "bounds"] = ((export_name, export_name + "nbounds"), self.directional_bounds)
        ds._coord_names.add(export_name + "bounds")
        return ds


class StructuredGrid2d(StructuredGrid1d):
    """A 2D structured (raster) topology: the outer product of two axes,
    cells y-major in the coordinates' own order."""

    def __init__(self, obj, name_x: str = "x", name_y: str = "y"):
        self.xbounds = StructuredGrid1d(obj, name_x)
        self.ybounds = StructuredGrid1d(obj, name_y)

    @property
    def coords(self) -> dict:
        return {**self.ybounds.coords, **self.xbounds.coords}

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dims(self) -> Tuple[str, str]:
        return self.ybounds.dims + self.xbounds.dims

    @property
    def size(self) -> int:
        return self.ybounds.size * self.xbounds.size

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.ybounds.size, self.xbounds.size)

    @property
    def area(self) -> np.ndarray:
        return np.multiply.outer(self.ybounds.length, self.xbounds.length)

    def convert_to(self, matched_type: Any) -> Any:
        """This grid as ``matched_type``: itself, or the Ugrid2d of its
        directional bounds (faces y-major in the coordinates' order)."""
        from xugrid_tpu_torch.regrid.unstructured import UnstructuredGrid2d

        if matched_type == StructuredGrid2d:
            return self
        if matched_type == UnstructuredGrid2d:
            with timed("structured.to_ugrid2d"):
                grid = Ugrid2d.from_structured_bounds(
                    self.xbounds.directional_bounds, self.ybounds.directional_bounds
                )
            return UnstructuredGrid2d(grid)
        raise TypeError(f"Cannot convert StructuredGrid2d to {matched_type.__name__}")

    def _broadcast_sorted(self, other, sy, sx, ty, tx, wy, wx):
        return _sorted(*broadcast(self.shape, other.shape, (sy, sx), (ty, tx), (wy, wx)))

    def overlap(self, other, relative: bool):
        """(Relative) area-of-overlap join with another structured grid."""
        with timed("structured.overlap"):
            sx, tx, wx = self.xbounds.overlap(other.xbounds, relative)
            sy, ty, wy = self.ybounds.overlap(other.ybounds, relative)
            return self._broadcast_sorted(other, sy, sx, ty, tx, wy, wx)

    def locate_centroids(self, other, tolerance=None):
        """Containment join of target cell centres."""
        with timed("structured.locate_centroids"):
            sx, tx, wx = self.xbounds.locate_centroids(other.xbounds)
            sy, ty, wy = self.ybounds.locate_centroids(other.ybounds)
            return self._broadcast_sorted(other, sy, sx, ty, tx, wy, wx)

    def linear_weights(self, other):
        """Bilinear interpolation weights at target cell centres."""
        with timed("structured.linear_weights"):
            sx, tx, wx = self.xbounds.linear_weights(other.xbounds)
            sy, ty, wy = self.ybounds.linear_weights(other.ybounds)
            return self._broadcast_sorted(other, sy, sx, ty, tx, wy, wx)

    def to_dataset(self, name: str):
        """Both axes (``StructuredGrid1d.to_dataset``) and a ``{name}_type``
        variable naming this adapter and the axes' coordinate names."""
        ds = self.xbounds.to_dataset(name).merge(self.ybounds.to_dataset(name))
        ds[name + "_type"] = (
            (),
            np.int64(-1),
            {"type": "StructuredGrid2d", "name_x": self.xbounds.name, "name_y": self.ybounds.name},
        )
        return ds


class StructuredGrid3d(StructuredGrid2d):
    """A voxel topology: the outer product of z, y and x axes, cells
    z-major."""

    def __init__(self, obj, name_x="x", name_y="y", name_z="z"):
        self.xbounds = StructuredGrid1d(obj, name_x)
        self.ybounds = StructuredGrid1d(obj, name_y)
        self.zbounds = StructuredGrid1d(obj, name_z)

    @property
    def ndim(self) -> int:
        return 3

    @property
    def dims(self):
        return self.zbounds.dims + self.ybounds.dims + self.xbounds.dims

    @property
    def shape(self):
        return (self.zbounds.size, self.ybounds.size, self.xbounds.size)

    @property
    def size(self) -> int:
        return self.zbounds.size * self.ybounds.size * self.xbounds.size

    @property
    def volume(self) -> np.ndarray:
        return np.multiply.outer(self.zbounds.length, self.area)

    def _broadcast_sorted3(self, other, sz, sy, sx, tz, ty, tx, wz, wy, wx):
        return _sorted(*broadcast(self.shape, other.shape, (sz, sy, sx), (tz, ty, tx), (wz, wy, wx)))

    def overlap(self, other, relative: bool):
        """(Relative) volume-of-overlap join with another voxel grid."""
        with timed("structured.overlap"):
            sx, tx, wx = self.xbounds.overlap(other.xbounds, relative)
            sy, ty, wy = self.ybounds.overlap(other.ybounds, relative)
            sz, tz, wz = self.zbounds.overlap(other.zbounds, relative)
            return self._broadcast_sorted3(other, sz, sy, sx, tz, ty, tx, wz, wy, wx)

    def locate_centroids(self, other, tolerance=None):
        """Containment join of target voxel centres."""
        with timed("structured.locate_centroids"):
            sx, tx, wx = self.xbounds.locate_centroids(other.xbounds)
            sy, ty, wy = self.ybounds.locate_centroids(other.ybounds)
            sz, tz, wz = self.zbounds.locate_centroids(other.zbounds)
            return self._broadcast_sorted3(other, sz, sy, sx, tz, ty, tx, wz, wy, wx)

    def linear_weights(self, other):
        """Trilinear interpolation weights at target voxel centres."""
        with timed("structured.linear_weights"):
            sx, tx, wx = self.xbounds.linear_weights(other.xbounds)
            sy, ty, wy = self.ybounds.linear_weights(other.ybounds)
            sz, tz, wz = self.zbounds.linear_weights(other.zbounds)
            return self._broadcast_sorted3(other, sz, sy, sx, tz, ty, tx, wz, wy, wx)


class ExplicitStructuredGrid3d:
    """
    A layered topology: per-column explicit z-bounds over a structured
    (y, x) footprint (e.g. geological layer models).  ``obj`` carries x
    and y coordinates and a ``{z}bounds`` array of shape (nlayer, y * x,
    2), each column's layers ascending.
    """

    def __init__(self, obj, name_x="x", name_y="y", name_z="z"):
        self.xbounds = StructuredGrid1d(obj, name_x)
        self.ybounds = StructuredGrid1d(obj, name_y)
        zbounds_name = f"{name_z}bounds"
        zb = np.asarray(obj[zbounds_name].data, dtype=np.float64)
        if zb.ndim != 3:
            raise ValueError(f"{zbounds_name} must have shape (nlayer, n_yx, 2), received: {zb.shape}")
        self.zbounds = zb

    @property
    def shape(self):
        return (self.zbounds.shape[0], self.ybounds.size, self.xbounds.size)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def area(self) -> np.ndarray:
        return np.multiply.outer(self.ybounds.length, self.xbounds.length)

    def overlap(self, other, relative: bool):
        """Volume overlap against a voxel or layered grid: the (y, x)
        footprints joined as rasters, then each overlapping column pair's
        layers by an interval join."""
        with timed("structured.overlap_layered"):
            sx, tx, wx = self.xbounds.overlap(other.xbounds, relative)
            sy, ty, wy = self.ybounds.overlap(other.ybounds, relative)
            source_yx, target_yx, weights_yx = broadcast(
                self.shape[1:], other.shape[1:], (sy, sx), (ty, tx), (wy, wx)
            )
            if isinstance(other, StructuredGrid3d):
                other_zbounds = other.zbounds.bounds[np.newaxis]
                target_rows = np.zeros(len(target_yx), dtype=np.int64)
            elif isinstance(other, ExplicitStructuredGrid3d):
                other_zbounds = np.swapaxes(other.zbounds, 0, 1)
                target_rows = target_yx
            else:
                raise TypeError(f"Cannot overlap with {type(other).__name__}")

            self_zbounds = np.swapaxes(self.zbounds, 0, 1)  # (n_yx, nlayer, 2)
            source_zyx, target_zyx, weights_z, pair = overlap_1d_nd(
                self_zbounds, other_zbounds, source_yx, target_rows
            )
            weights = weights_z * weights_yx[pair]
            # Per-column linear indices (column * n_layer + z) back to
            # global (z, y, x) linear indices.
            n_layer = self.zbounds.shape[0]
            src_col = source_zyx // n_layer
            src_z = source_zyx % n_layer
            source_index = src_z * (self.shape[1] * self.shape[2]) + src_col
            n_yx_other = other.shape[1] * other.shape[2]
            if isinstance(other, StructuredGrid3d):
                target_index = target_zyx * n_yx_other + target_yx[pair]
            else:
                n_other_layer = other.zbounds.shape[0]
                tgt_col = target_zyx // n_other_layer
                tgt_z = target_zyx % n_other_layer
                target_index = tgt_z * n_yx_other + tgt_col
            return _sorted(source_index, target_index, weights)
