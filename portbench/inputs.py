"""The inputs of a run, made from its seed and handed alike to the port
and to the reference: the quad mesh, the rasters and the payload.  Host
arrays are float64 / int64 numpy; the payload is made on the run's
device with a ``torch.Generator`` there."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: Stream numbers: each kind of input draws from its own generator, so
#: that adding one kind leaves the others as they were.
MESH, PAYLOAD, KEEP, SHIFTS = range(1, 5)


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**63, stream, *(m % 2**32 for m in more)])


def torch_generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    generator = torch.Generator(device=device)
    generator.manual_seed(int(rng(seed, stream).integers(2**62)))
    return generator


@dataclass
class Mesh:
    nodes: np.ndarray  # (N, 2) float64
    faces: np.ndarray  # (F, 4) int64, counterclockwise
    bounds: tuple  # (xmin, ymin, xmax, ymax)


def quad_mesh(nx: int, ny: int, cell: float, origin=(0.0, 0.0), jitter: float = 0.0, seed: int = 0) -> Mesh:
    """nx x ny square faces of side ``cell`` from ``origin``, numbered row
    by row from the south-west, interior nodes jittered by up to
    ``jitter`` cells in x and y (the boundary stays straight)."""
    x = origin[0] + np.arange(nx + 1.0) * cell
    y = origin[1] + np.arange(ny + 1.0) * cell
    yy, xx = np.meshgrid(y, x, indexing="ij")
    nodes = np.column_stack([xx.ravel(), yy.ravel()])
    if jitter:
        shift = rng(seed, MESH).uniform(-jitter * cell, jitter * cell, nodes.shape)
        j, i = np.divmod(np.arange(len(nodes)), nx + 1)
        shift[(i == 0) | (i == nx) | (j == 0) | (j == ny)] = 0.0
        nodes = nodes + shift
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    corner = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack([corner(i, j), corner(i + 1, j), corner(i + 1, j + 1), corner(i, j + 1)], axis=-1)
    bounds = (x[0], y[0], x[-1], y[-1])
    return Mesh(np.ascontiguousarray(nodes), faces.reshape(-1, 4).astype(np.int64), bounds)


@dataclass
class Raster:
    """nx x ny square cells of size ``cell``; column c spans
    [left + c cell, left + (c + 1) cell], row r (north first when
    ``descending``) spans [bottom + (ny - r - 1) cell, bottom + (ny - r) cell]."""

    nx: int
    ny: int
    cell: float
    left: float
    bottom: float
    descending: bool = True

    @property
    def size(self) -> int:
        return self.nx * self.ny

    @property
    def x(self) -> np.ndarray:
        return self.left + (np.arange(self.nx) + 0.5) * self.cell

    @property
    def y(self) -> np.ndarray:
        y = self.bottom + (np.arange(self.ny) + 0.5) * self.cell
        return y[::-1].copy() if self.descending else y


def raster(bounds, cell: float, shift=(0.0, 0.0), descending: bool = True) -> Raster:
    """Cells of ``cell`` over ``bounds`` = (xmin, ymin, xmax, ymax), the
    origin moved by ``shift``."""
    nx = int(round((bounds[2] - bounds[0]) / cell))
    ny = int(round((bounds[3] - bounds[1]) / cell))
    return Raster(nx, ny, cell, bounds[0] + float(shift[0]), bounds[1] + float(shift[1]), descending)


def payload_pool(slices: int, size: int, nan_share: float, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    """(slices, size) of ``dtype`` on ``device``: 10 + N(0, 1), each value
    NaN with probability ``nan_share``; made in blocks of 256 slices."""
    generator = torch_generator(seed, PAYLOAD, device)
    pool = torch.empty((slices, size), dtype=dtype, device=device)
    for start in range(0, slices, 256):
        block = pool[start : start + 256]
        torch.randn(block.shape, generator=generator, device=device, out=block)
        block.add_(10.0)
        missing = torch.rand(block.shape, generator=generator, device=device) < nan_share
        block.masked_fill_(missing, float("nan"))
    return pool


def subcell_shift(cell: float, seed: int, job: int) -> tuple:
    """A shift of a raster's origin by less than one cell in x and y."""
    return tuple(rng(seed, SHIFTS, job).uniform(0.0, cell, 2))
