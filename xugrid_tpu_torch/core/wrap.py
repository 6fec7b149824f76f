"""
UgridDataArray / UgridDataset: labelled data paired with UGRID
topologies, as in ``xugrid_tpu/core/wrap.py``.

Methods and attributes of the wrapped xdata object are forwarded
(``__getattr__``); results that still carry a UGRID dimension come back
wrapped with the grids.  A UgridDataset made from a dataset alone reads
its topologies from the UGRID variables.  The UGRID dimensions get
position coordinates, so a forwarded operation that subsets one is
seen, and its grid is subset with it (``ugridbase.align``).  The
payload may be a torch tensor and stays on its device.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.ugrid import conventions
from xugrid_tpu_torch.ugrid.ugrid1d import Ugrid1d
from xugrid_tpu_torch.ugrid.ugrid2d import Ugrid2d
from xugrid_tpu_torch.ugrid.ugridbase import AbstractUgrid, align, dim_coordinates
from xugrid_tpu_torch.utils.profiling import count


def get_ugrid_dims(obj, grids) -> set:
    """The UGRID dimensions of ``grids`` that ``obj`` has."""
    dims = set()
    for grid in grids:
        dims |= grid.dims & set(obj.dims)
    return dims


def assign_ugrid_coords(obj, grids):
    """Position coordinates on the UGRID dims that have none, so that
    subsetting is observable after forwarded operations; while spans are
    recorded, their bytes count as ``wrap.coord_bytes``."""
    ugrid_dims = {dim for grid in grids for dim in grid.dims} & set(obj.dims)
    sizes = obj.sizes
    coords = {dim: np.arange(sizes[dim]) for dim in ugrid_dims if dim not in obj.coords}
    if coords:
        count("wrap.coord_bytes", sum(index.nbytes for index in coords.values()))
        obj = obj.assign_coords(coords)
    return obj


def maybe_xugrid(obj, grids, old_indexes=None):
    """Wrap xdata objects that still carry UGRID dims; pass the rest."""
    if not isinstance(obj, (xdata.DataArray, xdata.Dataset)):
        return obj
    item_grids = [grid for grid in grids if grid.dims.intersection(obj.dims)]
    if not item_grids:
        return obj
    aligned, aligned_grids = align(obj, item_grids, old_indexes)
    if isinstance(aligned, xdata.DataArray):
        return UgridDataArray(aligned, aligned_grids[0])
    return UgridDataset(aligned, aligned_grids)


def _host_array(a) -> np.ndarray:
    """A host numpy array of an array, a tensor or a DataArray."""
    if isinstance(a, xdata.DataArray):
        return np.asarray(a.values)
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def maybe_xdata(obj):
    """Unwrap Ugrid wrappers into their xdata objects."""
    if isinstance(obj, (UgridDataArray, UgridDataset)):
        return obj.obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(maybe_xdata(o) for o in obj)
    return obj


class _ForwardMixin:
    def _indexes_snapshot(self):
        """The UGRID dimensions' index coordinates (their arrays, not
        copied), which ``align`` compares after a forwarded call."""
        return dim_coordinates(self.obj, {dim for grid in self.grids for dim in grid.dims})

    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("obj", "grids"):
            raise AttributeError(name)
        attr = getattr(self.obj, name)
        if callable(attr) and not isinstance(attr, (xdata.DataArray, xdata.Dataset)):
            snapshot = self._indexes_snapshot()

            def wrapped(*args, **kwargs):
                args = tuple(maybe_xdata(a) for a in args)
                kwargs = {k: maybe_xdata(v) for k, v in kwargs.items()}
                return maybe_xugrid(attr(*args, **kwargs), self.grids, snapshot)

            wrapped.__name__ = name
            wrapped.__doc__ = getattr(attr, "__doc__", None)
            return wrapped
        return maybe_xugrid(attr, self.grids, self._indexes_snapshot())

    def _binary(self, other, op, reflexive=False):
        other_un = maybe_xdata(other)
        result = op(other_un, self.obj) if reflexive else op(self.obj, other_un)
        return maybe_xugrid(result, self.grids, self._indexes_snapshot())

    def __getitem__(self, key):
        return maybe_xugrid(self.obj[key], self.grids, self._indexes_snapshot())

    def __dir__(self):
        return list(set(super().__dir__()) | set(dir(self.obj)))

    def __repr__(self):
        return self.obj.__repr__()

    def __len__(self):
        return len(self.obj)


def _attach_operators(cls):
    from xugrid_tpu_torch.xdata.dataarray import BINARY_OPERATORS, REFLEXIVE_OPERATORS, UNARY_OPERATORS

    def make(op, reflexive):
        def method(self, other):
            return self._binary(other, op, reflexive)

        return method

    def make_unary(op):
        def method(self):
            return maybe_xugrid(op(self.obj), self.grids, self._indexes_snapshot())

        return method

    for name, op in BINARY_OPERATORS.items():
        setattr(cls, name, make(op, False))
    for name, op in REFLEXIVE_OPERATORS.items():
        setattr(cls, name, make(op, True))
    for name, op in UNARY_OPERATORS.items():
        setattr(cls, name, make_unary(op))
    cls.__hash__ = object.__hash__
    return cls


@_attach_operators
class UgridDataArray(_ForwardMixin):
    """An xdata.DataArray paired with one UGRID topology."""

    def __init__(self, obj: xdata.DataArray, grid: AbstractUgrid):
        if not isinstance(obj, xdata.DataArray):
            raise TypeError(f"obj must be xdata.DataArray. Received instead: {type(obj).__name__}")
        if grid is None:
            raise ValueError("grid is required")
        object.__setattr__(self, "grid", grid)
        object.__setattr__(self, "obj", assign_ugrid_coords(obj, [grid]))

    @property
    def grids(self):
        return [self.grid]

    @property
    def ugrid(self):
        """Topology-aware accessor."""
        from xugrid_tpu_torch.core.dataarray_accessor import UgridDataArrayAccessor

        return UgridDataArrayAccessor(self.obj, self.grid)

    def __setitem__(self, key, value):
        self.obj[key] = maybe_xdata(value)

    def __iter__(self):
        # The JAX package iterates the wrapped DataArray: the items are
        # plain DataArrays, not UgridDataArrays.
        return iter(self.obj)

    def __array__(self, dtype=None, copy=None):
        return self.obj.__array__(dtype)

    def __float__(self):
        return float(self.obj)

    def __int__(self):
        return int(self.obj)

    def __bool__(self):
        return bool(self.obj)

    def __setattr__(self, name, value):
        if name in ("grid", "obj"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.obj, name, value)

    def to_dataset(self, name=None):
        return UgridDataset(self.obj.to_dataset(name), self.grids)

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_data(data, grid, facet: str) -> "UgridDataArray":
        """A UgridDataArray from a 1D array or tensor on a grid facet
        ("node", "edge" or "face")."""
        return grid.create_data_array(data, facet)

    @staticmethod
    def from_structured2d(
        da: xdata.DataArray, x: str = None, y: str = None, x_bounds=None, y_bounds=None
    ) -> "UgridDataArray":
        """
        A UgridDataArray from a structured DataArray, its (y, x)
        dimensions flattened into the face dimension of the Ugrid2d of
        its cells (faces y-major in the coordinates' own order).  x and y
        name the coordinates (1D, or 2D for rotated and curvilinear
        grids), inferred when not given.

        With ``x_bounds`` and ``y_bounds``, (N, M, 4) corner bounds of a
        curvilinear grid, x and y name the (y, x) dimensions (or
        coordinates over them) and are required; NaN-masked and
        degenerate cells are dropped from the grid and the data.
        """
        if da.ndim < 2:
            raise ValueError(f"DataArray must have at least two spatial dimensions. Found: {da.dims}")
        if x_bounds is not None and y_bounds is not None:
            if x is None or y is None:
                raise ValueError("x and y must be provided for bounds")
            if y in da.dims and x in da.dims:
                dims = (y, x)
            elif da[x].ndim == 2:
                dims = tuple(da[x].dims)
            else:
                dims = (da[y].dims[0], da[x].dims[0])
            grid, index = Ugrid2d.from_structured_bounds(
                _host_array(x_bounds), _host_array(y_bounds), return_index=True
            )
        else:
            grid, dims = Ugrid2d.from_structured(da, x, y, return_dims=True)
            index = slice(None, None)
        extra_dims = [d for d in da.dims if d not in dims]
        flattened = da.transpose(*extra_dims, *dims).stack_dims(grid.face_dimension, list(dims))
        if not isinstance(index, slice):
            flattened = flattened.isel({grid.face_dimension: np.flatnonzero(index)})
        return UgridDataArray(flattened, grid)


class UgridDataset(_ForwardMixin):
    """An xdata.Dataset paired with one or more UGRID topologies.  Without
    ``grids``, the topologies are read from the dataset's UGRID variables
    (``ugrid_roles``), which are then dropped from the data."""

    def __init__(self, obj: xdata.Dataset = None, grids: Union[AbstractUgrid, Sequence[AbstractUgrid]] = None):
        if obj is None and grids is None:
            raise ValueError("At least one of obj and grids is required")
        if obj is None:
            obj = xdata.Dataset()
        if not isinstance(obj, xdata.Dataset):
            raise TypeError(f"obj must be xdata.Dataset. Received instead: {type(obj).__name__}")
        if grids is None:
            grids = []
            for topology in conventions.ugrid_roles(obj).topology:
                topodim = obj._variables[topology].attrs["topology_dimension"]
                if topodim == 1:
                    grids.append(Ugrid1d.from_dataset(obj, topology))
                elif topodim == 2:
                    grids.append(Ugrid2d.from_dataset(obj, topology))
                else:
                    raise ValueError(f"Invalid topology dimension: {topodim}")
            obj = self._remove_topology(obj, grids)
        else:
            grids = [grids] if isinstance(grids, AbstractUgrid) else list(grids)
            bad = [type(g).__name__ for g in grids if not isinstance(g, AbstractUgrid)]
            if bad:
                raise TypeError(f"grids must be Ugrid1d or Ugrid2d, received: {bad}")
        object.__setattr__(self, "grids", grids)
        object.__setattr__(self, "obj", assign_ugrid_coords(obj, grids))

    @staticmethod
    def _remove_topology(ds, grids):
        """``ds`` without the topology, connectivity and grid-mapping
        variables of ``grids`` (they live on the grids)."""
        remove = set()
        roles = conventions.ugrid_roles(ds)
        for grid in grids:
            remove.add(grid.name)
            for key in conventions._CONNECTIVITY_NAMES[grid.topology_dimension]:
                if key in grid._attrs:
                    remove.add(grid._attrs[key])
            gm = roles.grid_mapping_names.get(grid.name)
            if gm:
                remove.add(gm)
        return ds.drop_vars([v for v in remove if v in ds._variables], errors="ignore")

    @property
    def ugrid(self):
        """Topology-aware accessor."""
        from xugrid_tpu_torch.core.dataset_accessor import UgridDatasetAccessor

        return UgridDatasetAccessor(self.obj, self.grids)

    @property
    def grid(self):
        if len(self.grids) != 1:
            raise ValueError(f"Can only call .grid with a single topology, found {len(self.grids)}")
        return self.grids[0]

    def __contains__(self, key):
        return key in self.obj

    def __iter__(self):
        return iter(self.obj)

    def __setattr__(self, name, value):
        if name in ("grids", "obj"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.obj, name, value)

    def __setitem__(self, key, value):
        if isinstance(value, UgridDataArray):
            # A new topology joins the grids; one of the same name replaces it.
            names = [g.name for g in self.grids]
            if value.grid.name in names:
                self.grids[names.index(value.grid.name)] = value.grid
            else:
                self.grids.append(value.grid)
            self.obj[key] = value.obj
            object.__setattr__(self, "obj", assign_ugrid_coords(self.obj, self.grids))
        else:
            self.obj[key] = maybe_xdata(value)

    @staticmethod
    def from_geodataframe(geodataframe) -> "UgridDataset":
        """Convert a GeoDataFrame of polygons into a UgridDataset: one face
        per polygon, the columns as face variables."""
        grid = Ugrid2d.from_geodataframe(geodataframe)
        ds = xdata.Dataset()
        for column in geodataframe.columns:
            if column == "geometry":
                continue
            ds[column] = ((grid.face_dimension,), geodataframe[column].to_numpy())
        return UgridDataset(ds, [grid])

    @staticmethod
    def from_structured2d(dataset: xdata.Dataset, topology=None) -> "UgridDataset":
        """
        A UgridDataset from a rectilinear Dataset: per topology, the
        variables over both of its (y, x) dimensions flattened into the
        face dimension of its Ugrid2d, those over neither kept.
        ``topology`` maps a topology name to ``{"x": ..., "y": ...}``
        coordinate names, or None to infer them (default ``{"mesh2d":
        None}``; a string names one topology).  ``"bounds_x"`` and
        ``"bounds_y"`` options (arrays, DataArrays or variable names of
        (N, M, 4) corner bounds) build a curvilinear grid, x and y then
        naming the (y, x) dimensions; the cells they drop are dropped
        from every flattened variable.
        """
        if topology is None:
            topology = {"mesh2d": None}
        elif isinstance(topology, str):
            topology = {topology: None}
        out = None
        for name, options in topology.items():
            options = options or {}
            x = options.get("x")
            y = options.get("y")
            bounds_x = options.get("bounds_x")
            bounds_y = options.get("bounds_y")
            if bounds_x is not None:
                if isinstance(bounds_x, str):
                    bounds_x = dataset[bounds_x]
                if isinstance(bounds_y, str):
                    bounds_y = dataset[bounds_y]
                grid, index = Ugrid2d.from_structured_bounds(
                    _host_array(bounds_x), _host_array(bounds_y), name=name, return_index=True
                )
                if y in dataset.dims_sizes() and x in dataset.dims_sizes():
                    dims = (y, x)
                else:
                    dims = (dataset[y].dims[0], dataset[x].dims[0])
            else:
                grid, dims = Ugrid2d.from_structured(dataset, x, y, name=name, return_dims=True)
                index = slice(None, None)
            new_ds = xdata.Dataset(attrs=dict(dataset.attrs))
            for varname in dataset.data_vars:
                da = dataset[varname]
                if set(dims) <= set(da.dims):
                    extra = [d for d in da.dims if d not in dims]
                    flattened = da.transpose(*extra, *dims).stack_dims(grid.face_dimension, list(dims))
                    if not isinstance(index, slice):
                        flattened = flattened.isel({grid.face_dimension: np.flatnonzero(index)})
                    new_ds[varname] = flattened
                elif not set(dims) & set(da.dims):
                    new_ds[varname] = da
            part = UgridDataset(new_ds, [grid])
            out = part if out is None else UgridDataset(out.obj.merge(part.obj), out.grids + part.grids)
        return out
