"""
UGRID conventions: locate topology dummy variables, coordinates,
connectivities, dimensions, and grid mappings inside a Dataset.

Pure-metadata layer over xdata.Dataset implementing the UGRID-1.0
convention: the port's copy of ``xugrid_tpu/ugrid/conventions.py``,
with the same discovery rules as the reference's
xugrid/ugrid/conventions.py:1-624.
"""

from __future__ import annotations

import warnings
from collections import ChainMap
from itertools import chain
from typing import Dict, List, Optional, Tuple

from xugrid_tpu_torch.xdata.dataset import Dataset


class UgridDimensionError(Exception):
    pass


class UgridCoordinateError(Exception):
    pass


_DIM_NAMES = {
    1: ("node_dimension", "edge_dimension"),
    2: ("node_dimension", "face_dimension", "edge_dimension"),
}

_COORD_NAMES = {
    1: ("node_coordinates", "edge_coordinates"),
    2: ("node_coordinates", "face_coordinates", "edge_coordinates"),
}

_COORD_DIMS = {
    "node_coordinates": "node_dimension",
    "edge_coordinates": "edge_dimension",
    "face_coordinates": "face_dimension",
}

_CONNECTIVITY_NAMES = {
    1: ("edge_node_connectivity",),
    2: (
        "face_node_connectivity",
        "edge_node_connectivity",
        "face_edge_connectivity",
        "face_face_connectivity",
        "edge_face_connectivity",
        "boundary_node_connectivity",
    ),
}

# (dimension role of axis 0, required size of axis 1 or None)
_CONNECTIVITY_DIMS = {
    "face_node_connectivity": ("face_dimension", None),
    "edge_node_connectivity": ("edge_dimension", 2),
    "face_edge_connectivity": ("face_dimension", None),
    "face_face_connectivity": ("face_dimension", None),
    "edge_face_connectivity": ("edge_dimension", 2),
    "boundary_node_connectivity": ("boundary_edge_dimension", 2),
}

X_STANDARD_NAMES = ("projection_x_coordinate", "longitude")
Y_STANDARD_NAMES = ("projection_y_coordinate", "latitude")

PROJECTED = True
GEOGRAPHIC = False


def _xy_attrs(projected_std: str, geographic_std: str) -> dict:
    return {
        PROJECTED: {"standard_name": projected_std},
        GEOGRAPHIC: {"standard_name": geographic_std},
    }


DEFAULT_ATTRS = {
    **{
        f"{loc}_{ax}": _xy_attrs(
            X_STANDARD_NAMES[0] if ax == "x" else Y_STANDARD_NAMES[0],
            X_STANDARD_NAMES[1] if ax == "x" else Y_STANDARD_NAMES[1],
        )
        for loc in ("node", "edge", "face")
        for ax in ("x", "y")
    },
    **{
        role: {"cf_role": role, "start_index": 0, "_FillValue": -1}
        for role in _CONNECTIVITY_NAMES[2]
    },
}


def default_topology_attrs(name: str, topology_dimension: int) -> dict:
    """Default variable/dimension naming scheme for a topology ``name``."""
    if topology_dimension == 1:
        return {
            "cf_role": "mesh_topology",
            "long_name": "Topology data of 1D network",
            "topology_dimension": 1,
            "node_dimension": f"{name}_nNodes",
            "edge_dimension": f"{name}_nEdges",
            "edge_node_connectivity": f"{name}_edge_nodes",
            "node_coordinates": f"{name}_node_x {name}_node_y",
            "edge_coordinates": f"{name}_edge_x {name}_edge_y",
        }
    elif topology_dimension == 2:
        return {
            "cf_role": "mesh_topology",
            "long_name": "Topology data of 2D mesh",
            "topology_dimension": 2,
            "node_dimension": f"{name}_nNodes",
            "edge_dimension": f"{name}_nEdges",
            "face_dimension": f"{name}_nFaces",
            "max_face_nodes_dimension": f"{name}_nMax_face_nodes",
            "boundary_edge_dimension": f"{name}_nBoundary_edges",
            "edge_node_connectivity": f"{name}_edge_nodes",
            "face_node_connectivity": f"{name}_face_nodes",
            "face_edge_connectivity": f"{name}_face_edges",
            "edge_face_connectivity": f"{name}_edge_faces",
            "boundary_node_connectivity": f"{name}_boundary_nodes",
            "face_face_connectivity": f"{name}_face_faces",
            "node_coordinates": f"{name}_node_x {name}_node_y",
            "edge_coordinates": f"{name}_edge_x {name}_edge_y",
            "face_coordinates": f"{name}_face_x {name}_face_y",
        }
    raise ValueError(
        f"topology_dimension should be 1 or 2, received {topology_dimension}"
    )


def _var_attrs(ds: Dataset, name: str) -> dict:
    return ds._variables[name].attrs


def _get_topology(ds: Dataset) -> List[str]:
    return [
        name
        for name in ds._variables
        if name not in ds._coord_names
        and _var_attrs(ds, name).get("cf_role") == "mesh_topology"
    ]


def _infer_xy_coords(ds: Dataset, candidates: List[str]):
    x, y = [], []
    for candidate in candidates:
        stdname = _var_attrs(ds, candidate).get("standard_name")
        if stdname in X_STANDARD_NAMES:
            x.append(candidate)
        elif stdname in Y_STANDARD_NAMES:
            y.append(candidate)
    if not x and not y:
        first, second = candidates[0], candidates[1]
        warnings.warn(
            f"No standard_name of {X_STANDARD_NAMES + Y_STANDARD_NAMES} in "
            f"{candidates}.\nUsing {first} and {second} as projected x and y "
            "coordinates.",
            UserWarning,
            stacklevel=2,
        )
        x.append(first)
        y.append(second)
    elif not x:
        raise UgridCoordinateError(
            f"No standard_name of {X_STANDARD_NAMES} in {candidates}"
        )
    elif not y:
        raise UgridCoordinateError(
            f"No standard_name of {Y_STANDARD_NAMES} in {candidates}"
        )
    return x, y


def _get_coordinates(ds: Dataset, topologies: List[str]):
    out = {}
    for topology in topologies:
        attrs = _var_attrs(ds, topology)
        topodim = attrs["topology_dimension"]
        vardict = {}
        for name in _COORD_NAMES[topodim]:
            if name not in attrs:
                continue
            candidates = [c for c in str(attrs[name]).split(" ") if c in ds._variables]
            if len(candidates) == 0:
                warnings.warn(
                    f"the following variables are specified for UGRID {name}: "
                    f'"{attrs[name]}", but they are not present in the dataset',
                    UserWarning,
                    stacklevel=2,
                )
                continue
            if len(candidates) < 2:
                raise UgridCoordinateError(
                    f"{topology}: at least two values required for UGRID "
                    f'{name}, while only "{attrs[name]}" are specified.'
                )
            vardict[name] = _infer_xy_coords(ds, candidates)
        out[topology] = vardict
    return out


def _get_connectivity(ds: Dataset, topologies: List[str]):
    out = {}
    for topology in topologies:
        attrs = _var_attrs(ds, topology)
        topodim = attrs["topology_dimension"]
        out[topology] = {
            role: attrs[role]
            for role in _CONNECTIVITY_NAMES[topodim]
            if role in attrs and attrs[role] in ds._variables
        }
    return out


def _infer_dims(ds: Dataset, connectivities, coordinates, vardict):
    sizes = ds.dims_sizes()
    inferred: Dict[str, str] = {}
    for role, varname in connectivities.items():
        key0, key1 = _CONNECTIVITY_DIMS[role]
        var_dims = ds._variables[varname].dims
        if len(var_dims) != 2:
            raise UgridDimensionError(
                f"Expected {varname} with role {role} to have exactly 2 "
                f"dimensions, found {len(var_dims)}: {var_dims}"
            )
        declared = vardict.get(key0) or inferred.get(key0)
        dim0, dim1 = var_dims
        if declared is not None:
            if declared not in var_dims:
                raise UgridDimensionError(
                    f"{key0}: {declared} not in {role}: {varname} "
                    f"with dimensions: {var_dims}"
                )
            if declared != dim0:
                dim0, dim1 = dim1, dim0
        if isinstance(key1, int) and sizes[dim1] != key1:
            raise UgridDimensionError(
                f"Expected size {key1} for dimension {dim1} in variable "
                f"{varname} with role {role}, found instead: {sizes[dim1]}"
            )
        inferred[key0] = dim0

    for role, varnames in coordinates.items():
        key = _COORD_DIMS[role]
        declared = vardict.get(key) or inferred.get(key)
        for varname in chain.from_iterable(varnames):
            var_dims = ds._variables[varname].dims
            if len(var_dims) != 1:
                continue
            var_dim = var_dims[0]
            if declared is None:
                inferred[key] = var_dim
                declared = var_dim
            elif declared != var_dim:
                raise UgridDimensionError(
                    f"Conflicting names for {key}: {declared} versus {var_dim}"
                )
    return inferred


def _get_dimensions(ds: Dataset, topologies, connectivity, coordinates):
    out = {}
    for topology in topologies:
        attrs = _var_attrs(ds, topology)
        topodim = attrs["topology_dimension"]
        vardict = {k: attrs[k] for k in _DIM_NAMES[topodim] if k in attrs}
        inferred = _infer_dims(
            ds, connectivity[topology], coordinates[topology], vardict
        )
        out[topology] = {**inferred, **vardict}
    return out


def _get_grid_mapping_names(ds: Dataset, topologies, dimensions):
    out = {}
    varnames = set(ds._variables)
    for topology in topologies:
        out[topology] = None
        topo_dims = set(dimensions[topology].values())
        names = {
            var.attrs.get("grid_mapping") or var.encoding.get("grid_mapping")
            for var in ds._variables.values()
            if topo_dims & set(var.dims)
        } - {None}
        if not names:
            continue
        if len(names) > 1:
            raise ValueError(
                f"Multiple grid mappings found for topology '{topology}': "
                f"{names}. Variables on the same topology are expected to "
                "share a single coordinate reference system (CRS). Modify "
                "the grid_mapping attributes before converting to a "
                "UgridDataset."
            )
        name = next(iter(names))
        if name in varnames:
            out[topology] = name
        else:
            warnings.warn(
                "The following grid mapping variable is specified in the "
                "attribute or encoding of one or more variables, but is not "
                f"present in the dataset: {name}",
                UserWarning,
                stacklevel=2,
            )
    return out


def _infer_projected(ds: Dataset, topologies, coordinates):
    out = {}
    for topology in topologies:
        inferred = []
        for role, (x_vars, y_vars) in coordinates[topology].items():
            for x_varname, y_varname in zip(x_vars, y_vars):
                std = _var_attrs(ds, x_varname).get("standard_name")
                if std == X_STANDARD_NAMES[0]:
                    inferred.append((x_varname, True))
                elif std == X_STANDARD_NAMES[1]:
                    inferred.append((x_varname, False))
                std = _var_attrs(ds, y_varname).get("standard_name")
                if std == Y_STANDARD_NAMES[0]:
                    inferred.append((y_varname, True))
                elif std == Y_STANDARD_NAMES[1]:
                    inferred.append((y_varname, False))
        values = {v for _, v in inferred}
        if len(values) == 0:
            projected = None
        elif len(values) == 1:
            projected = values.pop()
        else:
            details = ", ".join(
                f"{n}: {'projected' if v else 'geographic'}" for n, v in inferred
            )
            warnings.warn(
                "Inconsistent standard_names across coordinates for topology "
                f"'{topology}': {details}. Returning None.",
                UserWarning,
                stacklevel=2,
            )
            projected = None
        out[topology] = projected
    return out


class UgridRolesAccessor:
    """
    Retrieve the names of UGRID variables in a Dataset.

    Use as ``ugrid_roles(ds)`` or ``UgridRolesAccessor(ds)``; mirrors
    xarray's ``ds.ugrid_roles`` accessor in the reference.
    """

    def __init__(self, ds: Dataset):
        self._ds = ds

    def __getitem__(self, key: str):
        if key not in self.topology:
            raise KeyError(key)
        return ChainMap(
            self.dimensions[key], self.coordinates[key], self.connectivity[key]
        )

    @property
    def topology(self) -> List[str]:
        """Names of topology dummy variables (cf_role == mesh_topology)."""
        return _get_topology(self._ds)

    @property
    def coordinates(self):
        """Coordinate variable names per topology, grouped x/y per role."""
        return _get_coordinates(self._ds, self.topology)

    @property
    def dimensions(self):
        """UGRID dimension names per topology (declared + inferred)."""
        return _get_dimensions(
            self._ds, self.topology, self.connectivity, self.coordinates
        )

    @property
    def connectivity(self):
        """Connectivity variable names per topology."""
        return _get_connectivity(self._ds, self.topology)

    @property
    def grid_mapping_names(self):
        """Grid mapping (CRS container) variable name per topology."""
        return _get_grid_mapping_names(self._ds, self.topology, self.dimensions)

    @property
    def is_projected(self):
        """True (projected), False (geographic), or None per topology."""
        return _infer_projected(self._ds, self.topology, self.coordinates)

    def __repr__(self):
        dimensions = self.dimensions
        coordinates = self.coordinates
        connectivity = self.connectivity
        grid_mapping_names = self.grid_mapping_names
        is_projected = self.is_projected

        def section(subtitle, entries, vardict):
            tab = "    "
            rows = [f"{tab}{subtitle}"]
            for role in entries:
                value = vardict.get(role, "n/a")
                rows.append(f"{tab}{tab}{role}: {value}")
            rows.append("")
            return rows

        rows = []
        for topology in self.topology:
            topodim = _var_attrs(self._ds, topology)["topology_dimension"]
            rows += [f"UGRID {topodim}D Topology {topology}:"]
            rows += section("Dimensions:", _DIM_NAMES[topodim], dimensions[topology])
            rows += section(
                "Connectivity:", _CONNECTIVITY_NAMES[topodim], connectivity[topology]
            )
            rows += section(
                "Coordinates:", _COORD_NAMES[topodim], coordinates[topology]
            )
            projected = is_projected[topology]
            crs_type = (
                "projected"
                if projected is True
                else "geographic"
                if projected is False
                else "unknown"
            )
            name = grid_mapping_names[topology]
            rows += [
                f"    Coordinate Type: {crs_type}",
                f"Grid Mapping Name: {name if name is not None else 'n/a'}",
                "",
            ]
        return "\n".join(rows)


def ugrid_roles(ds: Dataset) -> UgridRolesAccessor:
    return UgridRolesAccessor(ds)
