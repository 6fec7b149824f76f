"""What the regrid generators share: the configuration's inputs as the
port's objects, and the judgement of a raster result against the
reference."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench import inputs
from portbench.reference import overlap


def mesh_of(config: dict, seed: int) -> inputs.Mesh:
    mesh = config["mesh"]
    return inputs.quad_mesh(mesh["nx"], mesh["ny"], mesh["cell"], mesh["origin"], mesh["jitter"], seed)


def raster_of(config: dict, mesh: inputs.Mesh, shift=(0.0, 0.0)) -> inputs.Raster:
    raster = config["raster"]
    return inputs.raster(mesh.bounds, raster["cell"], shift, raster["descending"])


def port_grid(xt, mesh: inputs.Mesh):
    return xt.Ugrid2d(mesh.nodes[:, 0], mesh.nodes[:, 1], -1, mesh.faces)


def port_raster(xt, raster: inputs.Raster):
    """A raster DataArray with ``x``, ``y`` (north first when descending),
    ``dx`` and ``dy``, as a user builds a map to regrid onto."""
    dy = -raster.cell if raster.descending else raster.cell
    coords = {"y": raster.y, "x": raster.x, "dx": raster.cell, "dy": dy}
    data = np.zeros((raster.ny, raster.nx), dtype=np.float32)
    return xt.xdata.DataArray(data, coords=coords, dims=("y", "x"), name="map")


@dataclass
class Selection:
    """What one call regrids: rows of the pool, and the dims and shape of
    the result before the raster's (y, x)."""

    rows: slice
    dims: tuple
    shape: tuple

    @property
    def slices(self) -> int:
        return self.rows.stop - self.rows.start


class Payload:
    """The configuration's ``variables``, each (time, layer, face), as one
    (variables x time x layer, face) pool on the device, variable-major."""

    def __init__(self, config: dict, n_face: int, seed: int, device):
        payload = config["payload"]
        self.variables, self.time, self.layer = payload["variables"], payload["time"], payload["layer"]
        self.per_variable = self.time * self.layer
        dtype = getattr(torch, payload["dtype"])
        self.pool = inputs.payload_pool(
            self.variables * self.per_variable, n_face, payload["nan_share"], seed, device, dtype
        )

    def port_variables(self, xt, grid) -> list:
        """Each variable as a (time, layer, face) UgridDataArray over ``grid``."""
        shape = (self.time, self.layer, self.pool.shape[1])
        return [
            xt.UgridDataArray(
                xt.xdata.DataArray(self.pool[self.variable(v).rows].view(shape), dims=("time", "layer", grid.face_dimension), name="head"),
                grid,
            )
            for v in range(self.variables)
        ]

    def variable(self, v: int) -> Selection:
        start = (v % self.variables) * self.per_variable
        return Selection(slice(start, start + self.per_variable), ("time", "layer"), (self.time, self.layer))

    def field(self, k: int) -> tuple:
        """Field k, the fields taken in turn: (variable, time, layer) and
        its Selection."""
        e = k % (self.variables * self.per_variable)
        v, rest = divmod(e, self.per_variable)
        t, layer = divmod(rest, self.layer)
        return (v, t, layer), Selection(slice(e, e + 1), (), ())


def form_errors(out, raster: inputs.Raster, selection: Selection, device) -> int:
    """How many of the result's dims, shape, device and raster
    coordinates differ from what a regrid onto ``raster`` gives."""
    errors = 0
    errors += getattr(out, "dims", None) != selection.dims + ("y", "x")
    errors += tuple(getattr(out, "shape", ())) != selection.shape + (raster.ny, raster.nx)
    data = getattr(out, "data", None)
    errors += not isinstance(data, torch.Tensor) or data.device.type != device.type
    for name, expected in (("x", raster.x), ("y", raster.y)):
        try:
            errors += not np.array_equal(np.asarray(out[name].values), expected)
        except Exception:  # the output has no such coordinate, or none at all
            errors += 1
    return int(errors)


class RasterJudge:
    """Holds results onto a raster to the area-weighted mean that the
    reference works out from the mesh, the raster and the payload."""

    def __init__(self, mesh: inputs.Mesh, pool: torch.Tensor, device):
        self.mesh, self.pool, self.device = mesh, pool, device
        self.worst = {"mean_rel_err": 0.0, "nan_mismatch": 0, "form_errors": 0}

    def judge(self, out, raster: inputs.Raster, selection: Selection, triplets=None) -> tuple:
        """Adds one result (a DataArray, or a bare tensor whose form is
        not judged) to the worst readings; returns the reference's
        triplets (to reuse for the same raster)."""
        if not isinstance(out, torch.Tensor):
            self.worst["form_errors"] += form_errors(out, raster, selection, self.device)
        if triplets is None:
            triplets = overlap.overlap_triplets(self.mesh.nodes, self.mesh.faces, raster, self.device)
        expected = overlap.weighted_mean(triplets, self.pool[selection.rows], raster.size)
        got = torch.as_tensor(getattr(out, "data", out))
        if got.numel() != expected.numel():
            self.worst["nan_mismatch"] += expected.numel()
            return triplets
        got = got.reshape(expected.shape[0], -1)
        nan_mismatch, worst, scale = 0, 0.0, 0.0
        for start in range(0, expected.shape[0], 256):  # float64 in blocks, to keep the copy small
            e, g = expected[start : start + 256], got[start : start + 256].double()
            nan_got, nan_expected = torch.isnan(g), torch.isnan(e)
            nan_mismatch += int((nan_got != nan_expected).sum())
            both = ~nan_got & ~nan_expected
            if bool(both.any()):
                scale = max(scale, float(e[both].abs().max()))
                worst = max(worst, float((g[both] - e[both]).abs().max()))
        self.worst["nan_mismatch"] += nan_mismatch
        self.worst["mean_rel_err"] = max(self.worst["mean_rel_err"], worst / scale if scale else 0.0)
        return triplets

    def readings(self, limits: dict) -> dict:
        return {name: (value, limits[name]) for name, value in self.worst.items()}
