"""
The ``.ugrid`` accessor of a UgridDataArray: its topology, renaming,
coordinate assignment, the conversion to a UGRID dataset and file, box
selections, partitions, and the Laplace fill.  The port of
``xugrid_tpu/core/dataarray_accessor.py`` reduced to these; the rest of
the accessor is not ported.
"""

from __future__ import annotations

import scipy.sparse

from xugrid_tpu_torch import xdata
from xugrid_tpu_torch.core.accessorbase import AbstractUgridAccessor
from xugrid_tpu_torch.utils.profiling import timed


class UgridDataArrayAccessor(AbstractUgridAccessor):
    """Operations using the UGRID topology, via ``uda.ugrid``."""

    def __init__(self, obj: xdata.DataArray, grid):
        self.obj = obj
        self.grid = grid

    @property
    def grids(self):
        """The topology, as a list (as a UgridDataset gives its grids)."""
        return [self.grid]

    @property
    def name(self) -> str:
        """Name of the UGRID topology."""
        return self.grid.name

    @property
    def names(self):
        """Name of the UGRID topology, as a list."""
        return [self.grid.name]

    @property
    def topology(self) -> dict:
        """Mapping from name to UGRID topology."""
        return {self.name: self.grid}

    @property
    def bounds(self) -> dict:
        """Mapping from grid name to (minx, miny, maxx, maxy)."""
        return {self.grid.name: self.grid.bounds}

    @property
    def total_bounds(self):
        """(minx, miny, maxx, maxy) of the grid."""
        return self.grid.bounds

    def rename(self, name: str):
        """The array over this topology renamed to ``name``, its UGRID
        coordinate and dimension names with it."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        new_grid, name_dict = self.grid.rename(name, return_name_dict=True)
        present = tuple(self.obj.coords) + tuple(self.obj.dims)
        return UgridDataArray(self.obj.rename({k: v for k, v in name_dict.items() if k in present}), new_grid)

    def assign_node_coords(self):
        """The array with the grid's node coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        return UgridDataArray(self.grid.assign_node_coords(self.obj), self.grid)

    def assign_edge_coords(self):
        """The array with the grid's edge coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        return UgridDataArray(self.grid.assign_edge_coords(self.obj), self.grid)

    def assign_face_coords(self):
        """The array with the grid's face coordinates."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        if self.grid.topology_dimension == 1:
            raise TypeError("Cannot set face coords from a Ugrid1D topology")
        return UgridDataArray(self.grid.assign_face_coords(self.obj), self.grid)

    def sel(self, x=None, y=None):
        """The array and its topology in a box of UGRID x and y (two
        slices), as a UgridDataArray.  Selections along a line or at
        points are not ported."""
        from xugrid_tpu_torch.core.wrap import UgridDataArray

        return UgridDataArray(*self.grid.sel(self.obj, x, y))

    def label_partitions(self, n_part: int):
        """Partition labels of the grid with this array's integer values
        on the core dimension as the weights (a tensor payload is copied
        to the host)."""
        obj = self.obj
        grid = self.grid
        if tuple(obj.dims) != (grid.core_dimension,):
            raise ValueError(f"Weights must be associated with the core-dimension of the grid: {grid.core_dimension}")
        return grid.label_partitions(n_part=n_part, weights=obj.values)

    def to_dataset(self, optional_attributes: bool = False):
        """The array (named ``{grid}_data`` when unnamed) and the UGRID
        variables of its topology as one Dataset."""
        obj = self.obj
        if obj.name is None:
            obj = obj.rename(f"{self.grid.name}_data")
        return self.grid.to_dataset(obj.to_dataset(), optional_attributes)

    def laplace_interpolate(
        self,
        xy_weights: bool = True,
        direct_solve: bool = False,
        delta=0.0,
        relax=0.0,
        rtol: float = 0.0,
        atol: float = 1.0e-4,
        maxiter: int = 500,
        precondition_degree: int = 4,
        device=None,
    ):
        """
        Fill NaNs by solving Laplace's equation over the node or face
        adjacency, with the known values as boundary conditions: the
        port's ``laplace_interpolate`` (a Chebyshev-Jacobi preconditioned
        CG whose SpMV is the CUDA kernel ``csr_matvec``).  Slices of the
        extra dimensions that share one NaN pattern are solved together,
        as one batched solve.  ``delta`` and ``relax`` are accepted for
        the reference's signature and unused.

        The solve runs in float64 on ``device``: None means the device of
        a tensor payload, else the CUDA card; pass ``device="cpu"``
        without one.  The right-hand sides are built on the host, so a
        tensor payload is copied there for the solve; the result is
        float64, a tensor on the payload's device for a tensor payload,
        numpy for numpy.
        """
        from xugrid_tpu_torch.core.wrap import UgridDataArray
        from xugrid_tpu_torch.ugrid.interpolate import interpolate_na_helper, laplace_interpolate

        grid = self.grid
        da = self.obj
        ugrid_dim = grid.find_ugrid_dim(da)
        if ugrid_dim == grid.edge_dimension:
            raise ValueError("Laplace interpolation along edges is not allowed.")
        with timed("accessor.connectivity"):
            conn = grid.get_connectivity_matrix(ugrid_dim, xy_weights=xy_weights)
        with timed("accessor.components"):
            _, components_labels = scipy.sparse.csgraph.connected_components(conn)
        with timed("accessor.fill"):
            da_filled = interpolate_na_helper(
                da,
                ugrid_dim,
                func=laplace_interpolate,
                kwargs={
                    "connectivity": conn,
                    "use_weights": xy_weights,
                    "components_labels": components_labels,
                    "direct_solve": direct_solve,
                    "rtol": rtol,
                    "atol": atol,
                    "maxiter": maxiter,
                    "precondition_degree": precondition_degree,
                },
                device=device,
            )
        return UgridDataArray(da_filled, grid)
