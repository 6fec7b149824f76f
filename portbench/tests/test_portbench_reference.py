"""The reference against exact cases."""

import math

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import overlap

CPU = torch.device("cpu")


def square_mesh(n, size=1.0):
    mesh = inputs.quad_mesh(n, n, size)
    return mesh.nodes, mesh.faces


def test_faces_tiling_the_cells_give_the_mean_of_four():
    # 8 x 8 unit faces in 4 x 4 cells of 2: each cell holds 4 whole faces.
    nodes, faces = square_mesh(8)
    raster = inputs.raster((0.0, 0.0, 8.0, 8.0), 2.0)
    triplets = overlap.overlap_triplets(nodes, faces, raster, CPU)
    assert len(triplets[0]) == 64
    assert torch.allclose(triplets[2], torch.ones(64, dtype=torch.float64), rtol=0, atol=1e-15)
    values = torch.arange(64, dtype=torch.float32)[None, :]
    out = overlap.weighted_mean(triplets, values, 16)[0].reshape(4, 4)
    # Row 0 is north: cells of faces with rows 6-7.
    face_value = values[0].reshape(8, 8).double()
    expected = face_value.reshape(4, 2, 4, 2).mean(dim=(1, 3)).flip(0)
    assert torch.allclose(out, expected, rtol=0, atol=1e-12)


def test_nan_sources_are_skipped_and_empty_cells_are_nan():
    nodes, faces = square_mesh(2)  # 2 x 2 faces over [0, 2]^2
    raster = inputs.raster((0.0, 0.0, 4.0, 4.0), 2.0)  # only the south-west cell overlaps
    triplets = overlap.overlap_triplets(nodes, faces, raster, CPU)
    values = torch.tensor([[1.0, math.nan, 3.0, 5.0]])
    out = overlap.weighted_mean(triplets, values, 4)[0]
    # Descending rows: the south-west cell is row 1, column 0.
    assert out[2].item() == pytest.approx(3.0)
    assert torch.isnan(out[[0, 1, 3]]).all()


def test_square_over_four_cells_splits_in_quarters():
    nodes = np.array([[0.5, 0.5], [1.5, 0.5], [1.5, 1.5], [0.5, 1.5]])
    raster = inputs.raster((0.0, 0.0, 2.0, 2.0), 1.0)
    target, source, area = overlap.overlap_triplets(nodes, np.array([[0, 1, 2, 3]]), raster, CPU)
    assert sorted(target.tolist()) == [0, 1, 2, 3]
    assert torch.allclose(area, torch.full((4,), 0.25, dtype=torch.float64), rtol=0, atol=1e-15)


def test_diamond_clip_matches_the_analytic_area():
    # A diamond of half-diagonal 1 about (1, 1) in the cell [0, 1]^2: the
    # cell holds one quarter of its area 2.
    diamond = torch.tensor([[[1.0, 0.0], [2.0, 1.0], [1.0, 2.0], [0.0, 1.0]]], dtype=torch.float64)
    area = overlap.clip_areas(diamond, torch.tensor([[0.0, 1.0, 0.0, 1.0]], dtype=torch.float64))
    assert area.item() == pytest.approx(0.5, abs=1e-15)


def test_clipped_pieces_of_jittered_faces_add_up_to_each_face():
    mesh = inputs.quad_mesh(30, 30, 1.0, jitter=0.15, seed=3)
    raster = inputs.raster(mesh.bounds, 30 / 11)
    target, source, area = overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, CPU)
    total = torch.zeros(len(mesh.faces), dtype=torch.float64).index_add_(0, source, area)
    quads = mesh.nodes[mesh.faces] - mesh.nodes[mesh.faces][:, :1]
    face_area = 0.5 * (quads[..., 0] * np.roll(quads[..., 1], -1, 1) - np.roll(quads[..., 0], -1, 1) * quads[..., 1]).sum(1)
    assert torch.allclose(total, torch.from_numpy(face_area), rtol=0, atol=1e-14)


def test_bfloat16_mean_departs_from_float64():
    mesh = inputs.quad_mesh(20, 20, 1.0, jitter=0.15, seed=4)
    raster = inputs.raster(mesh.bounds, 2.5)
    triplets = overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, CPU)
    values = inputs.payload_pool(2, len(mesh.faces), 0.0, 4, CPU)
    exact = overlap.weighted_mean(triplets, values, 64)
    low = overlap.weighted_mean(triplets, values, 64, torch.bfloat16)
    assert float((low - exact).abs().max()) > 1e-3


def test_grid_cells_of_a_quarter_map_cell_tile_it_by_sixteen():
    # 8 x 12 faces of 250 m from RD (0, 300000) onto 1 km cells: a 2 x 3
    # map, each cell the mean of its 4 x 4 faces.
    mesh = inputs.quad_mesh(8, 12, 250.0, (0.0, 300000.0))
    assert mesh.bounds == (0.0, 300000.0, 2000.0, 303000.0)
    assert len(mesh.nodes) == 9 * 13 and len(mesh.faces) == 96
    raster = inputs.raster(mesh.bounds, 1000.0)
    assert (raster.nx, raster.ny, raster.size) == (2, 3, 6)
    assert np.array_equal(raster.y, [302500.0, 301500.0, 300500.0])
    triplets = overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, CPU)
    assert len(triplets[0]) == 96
    assert torch.allclose(triplets[2], torch.full((96,), 62500.0, dtype=torch.float64), rtol=0, atol=1e-9)
    values = torch.arange(96, dtype=torch.float32)[None, :]
    out = overlap.weighted_mean(triplets, values, 6)[0].reshape(3, 2)
    expected = values[0].reshape(12, 8).double().reshape(3, 4, 2, 4).mean(dim=(1, 3)).flip(0)
    assert torch.allclose(out, expected, rtol=0, atol=1e-12)


def test_a_shifted_map_takes_partial_faces_at_its_edges():
    mesh = inputs.quad_mesh(8, 8, 250.0)
    raster = inputs.raster(mesh.bounds, 1000.0, shift=(125.0, -500.0))
    target, source, area = overlap.overlap_triplets(mesh.nodes, mesh.faces, raster, CPU)
    total = torch.zeros(raster.size, dtype=torch.float64).index_add_(0, target, area)
    # Each cell keeps the part of [left, left + 1000] x [bottom, bottom + 1000] inside [0, 2000]^2.
    widths = np.array([1000.0, 875.0])
    heights = np.array([1000.0, 500.0])  # north row first
    assert torch.allclose(total, torch.from_numpy(np.outer(heights, widths).ravel()), rtol=0, atol=1e-9)
