"""
Partition and merge UGRID topologies and their data, the port of
``xugrid_tpu/ugrid/partitioning.py``.

* ``partition_labels``: entities ordered along the Hilbert curve of
  their coordinates (the native ``hilbert_distance``) and split into
  contiguous, weight-balanced parts.
* ``merge_partitions``: partitioned topologies and their data
  reassembled into one ``UgridDataset``: shared nodes, faces and edges
  deduplicated by exact equality (``core/dedup.py``, the native hashed
  pass), the data of each partition selected on its own entities and
  concatenated.  A tensor payload stays on its device through the
  selection, the padding of the connectivity dimensions and the
  concatenation.

Without the native host library the Hilbert distances and the merge
raise; ``hilbert_distance_plain`` is the numpy version the tests hold
the native one to.
"""

from __future__ import annotations

from collections import defaultdict
from itertools import accumulate, chain
from typing import List, Optional

import numpy as np
import torch

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.constants import FILL_VALUE, IntDType
from xugrid_tpu_torch.core.dedup import unique_rows
from xugrid_tpu_torch.utils.profiling import timed


# ---------------------------------------------------------------------------
# Partitioning
# ---------------------------------------------------------------------------
def hilbert_distance(xy: np.ndarray, order: int = 16) -> np.ndarray:
    """Distance along the Hilbert curve of 2^order cells over the
    points' bounding box, uint64 per 2D point.  Unlike the Morton curve,
    consecutive Hilbert cells are adjacent, so contiguous ranges form
    compact parts."""
    from xugrid_tpu_torch.utils.native import hilbert_distance_native

    native = hilbert_distance_native(xy, order)
    if native is None:
        raise RuntimeError("hilbert_distance needs the native host library (g++)")
    return native


def hilbert_distance_plain(xy: np.ndarray, order: int = 16) -> np.ndarray:
    """``hilbert_distance`` in numpy."""
    lo = xy.min(axis=0)
    hi = xy.max(axis=0)
    extent = np.maximum(hi - lo, 1e-300)
    side = (1 << order) - 1
    x = ((xy[:, 0] - lo[0]) / extent[0] * side).astype(np.uint64)
    y = ((xy[:, 1] - lo[1]) / extent[1] * side).astype(np.uint64)
    d = np.zeros_like(x)
    s = np.uint64(1) << np.uint64(order - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        # Rotate the quadrant.
        swap = ry == 0
        flip = swap & (rx == 1)
        x = np.where(flip, (s - one) - x, x)
        y = np.where(flip, (s - one) - y, y)
        x, y = np.where(swap, y, x), np.where(swap, x, y)
        s >>= one
    return d


def partition_labels(
    coordinates: np.ndarray,
    n_part: int,
    adjacency=None,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """
    One of ``n_part`` labels for every entity: entities ordered along the
    Hilbert curve of their coordinates and split into contiguous chunks
    of equal count, or of equal total weight.  ``adjacency`` is accepted
    for the reference's signature and unused.
    """
    n = len(coordinates)
    if n_part < 1:
        raise ValueError(f"n_part must be >= 1, received: {n_part}")
    if n_part > n:
        raise ValueError(f"Cannot partition {n} entities into {n_part} parts.")
    order = np.argsort(hilbert_distance(coordinates), kind="stable")
    if weights is None:
        bounds = (np.arange(1, n_part) * n) // n_part
    else:
        cum = np.cumsum(np.asarray(weights, dtype=np.float64)[order])
        bounds = np.searchsorted(cum, np.arange(1, n_part) * (cum[-1] / n_part))
    labels = np.empty(n, dtype=IntDType)
    chunk_sizes = np.diff(np.concatenate([[0], bounds, [n]])).astype(np.int64)
    labels[order] = np.repeat(np.arange(n_part), chunk_sizes)
    return labels


def labels_to_indices(labels: np.ndarray) -> List[np.ndarray]:
    """[0, 1, 0, 2, 2] -> [[0, 2], [1], [3, 4]]."""
    sorter = np.argsort(labels, kind="stable")
    split_indices = np.cumsum(np.bincount(labels)[:-1])
    indices = np.split(sorter, split_indices)
    for index in indices:
        index.sort()
    return indices


def partition_by_label(grid, obj, labels):
    """The grid and a DataArray or Dataset on it, split by integer labels
    on the grid's core dimension: a UgridDataArray or UgridDataset per
    label."""
    from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset

    if not isinstance(labels, UgridDataArray):
        raise TypeError(f"labels must be a UgridDataArray, received: {type(labels).__name__}")
    label_values = labels.values
    if not np.issubdtype(label_values.dtype, np.integer):
        raise TypeError(f"labels must have integer dtype, received {label_values.dtype}")
    if labels.grid != grid:
        raise ValueError("grid of labels does not match xugrid object")
    if tuple(labels.dims) != (grid.core_dimension,):
        raise ValueError(
            f"Can only partition this topology by {grid.core_dimension}, found the dimensions: {labels.dims}"
        )

    if isinstance(obj, xdata.Dataset):
        obj_type = UgridDataset
    elif isinstance(obj, xdata.DataArray):
        obj_type = UgridDataArray
    else:
        raise TypeError(f"Expected DataArray or Dataset, received: {type(obj).__name__}")

    indices = labels_to_indices(label_values)
    partitions = []
    for index in indices:
        with timed("partition.subset"):
            new_grid, indexes = grid.topology_subset(index, return_index=True)
        with timed("partition.isel"):
            new_obj = obj.isel({k: v.to_numpy() for k, v in indexes.items() if k in obj.dims})
        partitions.append(obj_type(new_obj, new_grid))
    return partitions


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------
def merge_nodes(grids):
    """Stacked nodes deduplicated by exact coordinates, in first-seen
    order: (unique xy, each partition's indexes into its own nodes, the
    inverse map of the stacked nodes)."""
    node_xy = np.column_stack(
        (np.hstack([grid.node_x for grid in grids]), np.hstack([grid.node_y for grid in grids]))
    )
    index, inverse = unique_rows(node_xy)
    unique_nodes = node_xy[index]
    slices = (0,) + tuple(accumulate(grid.n_node for grid in grids))
    # The sections are views: index itself becomes partition-local.
    indexes = np.split(index, np.searchsorted(index, slices[1:-1]))
    for partition_index, offset in zip(indexes, slices):
        partition_index -= offset
    return unique_nodes, indexes, inverse


def _merge_connectivity(gathered, slices):
    """Rows deduplicated regardless of their node order ([0, 1] equals
    [1, 0]), the first occurrence kept, in first-seen order: (merged
    rows, each partition's indexes into its own rows)."""
    from xugrid_tpu_torch.utils.native import get_lib, unique_sorted_rows_native

    if get_lib() is None:
        raise RuntimeError("merge_partitions needs the native host library (g++)")
    native = unique_sorted_rows_native(gathered)
    if native is not None:
        index = native[0]
    else:  # Rows wider than the native kernel's 64 entries.
        index, _ = unique_rows(np.sort(gathered, axis=1))
    merged = gathered[index]
    # The sections are views: index itself becomes partition-local.
    indexes = np.split(index, np.searchsorted(index, slices[1:-1]))
    for partition_index, offset in zip(indexes, slices):
        partition_index -= offset
    return merged, indexes


def merge_faces(grids, node_inverse):
    node_offsets = tuple(accumulate([0] + [grid.n_node for grid in grids]))
    n_face = [grid.n_face for grid in grids]
    n_max_node = max(grid.n_max_node_per_face for grid in grids)
    slices = (0,) + tuple(accumulate(n_face))

    all_faces = np.full((sum(n_face), n_max_node), FILL_VALUE, dtype=IntDType)
    for grid, face_offset, node_offset in zip(grids, slices, node_offsets):
        faces = grid.face_node_connectivity
        nf, n_node_per_face = faces.shape
        valid = faces != FILL_VALUE
        all_faces[face_offset : face_offset + nf, :n_node_per_face][valid] = node_inverse[faces[valid] + node_offset]
    return _merge_connectivity(all_faces, slices)


def merge_edges(grids, node_inverse):
    node_offsets = tuple(accumulate([0] + [grid.n_node for grid in grids]))
    n_edge = [grid.n_edge for grid in grids]
    slices = (0,) + tuple(accumulate(n_edge))

    all_edges = np.empty((sum(n_edge), 2), dtype=IntDType)
    for grid, edge_offset, offset in zip(grids, slices, node_offsets):
        edges = grid.edge_node_connectivity
        all_edges[edge_offset : edge_offset + len(edges)] = node_inverse[edges + offset]
    return _merge_connectivity(all_edges, slices)


def validate_partition_topology(grouped) -> None:
    for name, grids in grouped.items():
        types = {type(grid) for grid in grids}
        if len(types) > 1:
            raise TypeError(
                f"All partition topologies with name {name} should be of the same type, received: {types}"
            )
        griddims = list({tuple(sorted(grid.dims)) for grid in grids})
        if len(griddims) > 1:
            raise ValueError(
                f"Dimension names on UGRID topology {name} do not match across partitions: "
                f"{griddims[0]} versus {griddims[1]}"
            )


def group_grids_by_name(partitions):
    grouped = defaultdict(list)
    for partition in partitions:
        for grid in partition.grids:
            grouped[grid.name].append(grid)
    validate_partition_topology(grouped)
    return grouped


def group_data_objects_by_gridname(partitions):
    data_objects = [p.obj.to_dataset() if isinstance(p.obj, xdata.DataArray) else p.obj for p in partitions]
    grouped = defaultdict(list)
    for partition, obj in zip(partitions, data_objects):
        for grid in partition.grids:
            grouped[grid.name].append(obj)
    return grouped


def validate_partition_objects(objects_by_gridname) -> None:
    for data_objects in objects_by_gridname.values():
        allvars = list({tuple(sorted(ds.data_vars)) for ds in data_objects})
        for var in set(chain(*allvars)):
            vardims = {ds._variables[var].dims for ds in data_objects if var in ds.data_vars}
            if len(vardims) > 1:
                vardims_ls = list(vardims)
                raise ValueError(
                    f"Dimensions for '{var}' do not match across partitions: {vardims_ls[0]} versus {vardims_ls[1]}"
                )


def separate_variables(objects_by_gridname, ugrid_dims):
    """The variables split into those on a UGRID dimension (by dimension)
    and the others (by grid name)."""
    validate_partition_objects(objects_by_gridname)

    def remove_item(tup, index):
        return tup[:index] + tup[index + 1 :]

    def all_equal(iterable):
        items = list(iterable)
        return all(element == items[0] for element in items)

    grouped = defaultdict(set)
    other = defaultdict(set)
    for gridname, data_objects in objects_by_gridname.items():
        variables = {varname: var for obj in data_objects for varname, var in obj._variables.items()}
        for var, variable in variables.items():
            dims = variable.dims
            shapes = [obj._variables[var].shape for obj in data_objects if var in obj]
            intersection = ugrid_dims.intersection(dims)
            if intersection:
                if len(intersection) > 1:
                    raise ValueError(f"{var} contains more than one UGRID dimension: {intersection}")
                dim = intersection.pop()
                axis = dims.index(dim)
                shapes = [remove_item(shape, axis) for shape in shapes]
                if all_equal(shapes):
                    grouped[dim].add(var)
            elif all_equal(shapes):
                other[gridname].add(var)
    return grouped, other


def merge_data_along_dim(data_objects, variables, merge_dim, indexes, merged_grid):
    """Each partition's variables selected on its own entities of
    ``merge_dim``, padded along the connectivity dimensions, and
    concatenated."""
    max_sizes = merged_grid.max_connectivity_sizes
    ugrid_connectivity_dims = set(max_sizes)

    to_merge = []
    for obj, index in zip(data_objects, indexes):
        missing_vars = set(variables).difference(set(obj._variables))
        if missing_vars:
            raise ValueError(f"Missing variables: {missing_vars} in partition")
        selection = obj[sorted(variables)]
        if merge_dim in selection.dims_sizes():
            selection = selection.isel({merge_dim: index})
        for dim in ugrid_connectivity_dims.intersection(selection.dims_sizes()):
            size = selection.dims_sizes()[dim]
            if size != max_sizes[dim]:
                selection = _pad_dim(selection, dim, max_sizes[dim] - size)
        to_merge.append(selection)
    return xdata.concat(to_merge, dim=merge_dim)


def _pad_dim(ds: xdata.Dataset, dim: str, count: int) -> xdata.Dataset:
    """``ds`` with ``count`` entries appended along ``dim``: FILL_VALUE for
    integers, NaN otherwise; a tensor is padded on its own device."""
    out = xdata.Dataset(attrs=dict(ds.attrs))
    out._coord_names = set(ds._coord_names)
    for name, var in ds._variables.items():
        if dim not in var.dims:
            out._variables[name] = var
            continue
        axis = var.dims.index(dim)
        data = var.data
        if isinstance(data, torch.Tensor):
            is_int = not (data.dtype.is_floating_point or data.dtype.is_complex or data.dtype == torch.bool)
            shape = list(data.shape)
            shape[axis] = count
            pad = torch.full(shape, FILL_VALUE if is_int else np.nan, dtype=data.dtype, device=data.device)
            data = torch.cat([data, pad], dim=axis)
        else:
            widths = [(0, 0)] * var.ndim
            widths[axis] = (0, count)
            fill = FILL_VALUE if np.issubdtype(var.dtype, np.integer) else np.nan
            data = np.pad(np.asarray(data), widths, constant_values=fill)
        out._variables[name] = xdata.Variable(var.dims, data, var.attrs)
    return out


def merge_partitions(partitions, merge_ugrid_chunks: bool = True):
    """
    Merge topologies and data partitioned along UGRID dimensions into one
    UgridDataset.

    Parameters
    ----------
    partitions: sequence of UgridDataArray or UgridDataset
    merge_ugrid_chunks: bool
        Accepted for the reference's signature; the port has no chunks.

    Returns
    -------
    merged: UgridDataset (the partition itself when given one)
    """
    from xugrid_tpu_torch.core.wrap import UgridDataArray, UgridDataset

    if len(partitions) == 0:
        raise ValueError("Cannot merge partitions: zero partitions provided.")
    types = {type(obj) for obj in partitions}
    msg = "Expected UgridDataArray or UgridDataset, received: {}"
    if len(types) > 1:
        raise TypeError(msg.format([t.__name__ for t in types]))
    obj_type = types.pop()
    if obj_type not in (UgridDataArray, UgridDataset):
        raise TypeError(msg.format(obj_type.__name__))
    if len(partitions) == 1:
        return next(iter(partitions))

    grids = [grid for p in partitions for grid in p.grids]
    ugrid_dims = {dim for grid in grids for dim in grid.dims}
    grids_by_name = group_grids_by_name(partitions)
    data_objects_by_name = group_data_objects_by_gridname(partitions)
    vars_by_dim, other_vars_by_name = separate_variables(data_objects_by_name, ugrid_dims)

    merged = xdata.Dataset()
    merged_grids = []
    for gridname, grids in grids_by_name.items():
        data_objects = data_objects_by_name[gridname]
        other_vars = other_vars_by_name[gridname]

        merged_grid, indexes = grids[0].merge_partitions(grids)
        merged_grids.append(merged_grid)

        with timed("merge.data"):
            for obj in data_objects:
                present = set(other_vars).intersection(set(obj.data_vars))
                if present:
                    merged.update(obj[sorted(present)])
            for dim, dim_indexes in indexes.items():
                variables = vars_by_dim[dim]
                if len(variables) == 0:
                    continue
                merged.update(merge_data_along_dim(data_objects, variables, dim, dim_indexes, merged_grid))

    return UgridDataset(merged, merged_grids)
