"""
Runs the PyTorch port (``xugrid_tpu_torch``) on one CUDA card and checks
it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare LABEL

With no argument it runs these phases:

1. The card's name and power limit, the versions, and the build of the
   CUDA kernels (nvcc, sm_90a) and of the native host library from the
   sources in this checkout.
2. Each kernel against its plain PyTorch version on the card, in
   float32 and float64, at every lane mapping its wrapper picks: every
   method of window_reduce on the slices-major (E, m) source at E = 1,
   3, 20, 40, 128 and 200 (each slice-warp count and slice batch), on
   windows with NaN, +-inf, zeros, negative values, zero weights, more
   than 32 slots, all-pad rows and a target count that no tile divides,
   on windows of up to 400 slots (read in place), and on the first 1 to
   4 slots of each window (row tiles, bit for bit as the tile block);
   window_select's
   mode and percentiles at the same slice counts, at each register array
   (K = 8, 16, 32) and on the walk of windows longer than 32 slots, bit
   for bit; and csr_matvec on ragged rows (empty rows, rows of more than
   32 entries, negative and zero weights) at E = 1, 2, 3, 8 and 20, bit
   for bit, two launches equal.  And ``cg_solve`` refuses a NaN or inf
   right-hand side.  The build's ptxas report must show no stack frame
   and no spill for every window_select instantiation.
3. The main path at the 1M-face config of ``bench.py``: a jittered
   1000 x 1000 quad mesh regridded onto a 512 x 512 raster, 20 extra
   slices of float32, through ``OverlapRegridder`` (mean, median, mode)
   and ``RelativeOverlapRegridder`` (first_order_conservative).  The
   launch counters show which kernel ran; each output is held against
   the plain version on the card and against an independent host
   reference (scipy CSR products for the linear methods, numpy
   percentiles and weighted modes on a sample of targets).
4. Kernel, plain and apply-pass times at E = 1, 20 and 128 (CUDA
   events around back-to-back calls, median of passes after warm-up;
   and one call from an idle card, as earlier runs timed), with true
   bytes per pass, GB/s, the share of the card's measured copy
   bandwidth, the bound, and a library yardstick: ``torch.sparse.mm``
   of the same weights with the staged (m, E) copy for the sum-kind
   methods, ``torch.nanquantile`` over the pre-gathered (n, E, w)
   windows for the median.  Each pass is one launch on the (E, m)
   source (every device activity the profiler records is a launch of
   the kernel);
   window_select's lines add its pair steps, sum over targets of len^2
   times E.
5. The Laplace fill at ``scripts/laplace_scale_demo.py``'s 1M
   configuration: a shuffled Delaunay mesh of 1,002,001 nodes, 2 %
   known, unit weights, atol 1e-6, through ``laplace_interpolate`` at
   precondition degree 1 and 4 and for a stack of 20 slices at degree
   4.  csr_matvec's launches must equal 1 + (degree - 1) + iterations *
   degree per solve; every column's residual in the unknown system,
   computed on the host with scipy in float64, must be at most 10 *
   atol.  Then the structured-derived 1000 x 1000 triangle mesh through
   the same path and checks.
6. csr_matvec's time on the 1M system (float64 and float32, E = 1 and
   20) beside its plain version, ``torch.sparse.mm`` and its bound,
   warm and with a cold L2 (256 MB written between launches); the
   solves' wall, device and host seconds, the host split by stage
   (content hash, system preparation, right-hand sides, scatter); a
   profiler trace of one degree-4 solve.
7. The other regridders at phase 3's 1M config (its meshes and data):
   ``CentroidLocatorRegridder`` mesh -> raster launches no kernel and
   equals numpy's ``out[:, row] = data[:, col]`` bit for bit;
   ``BarycentricInterpolator`` mesh -> raster (262,144 points located in
   the 1M mesh's tessellation) and raster -> mesh (1,000,000 points in
   the raster's) launches only window_reduce, matches the plain version
   and a scipy CSR product, its weight rows sum to 1 within 1e-12, a
   linear field 2x + 3y + 1 comes back within rtol 1e-9 two source cells
   inside the boundary, and the weights built with the tessellation's
   angle sort on the card equal those sorted on the host (triplets
   sorted by (target, source): indices equal, weights rtol 1e-12);
   ``NetworkGridder`` grids 100 random-walk polylines of 1,000 segments
   (100,000 edges, 0.5-1.5 long) onto the 1M mesh, mean through
   window_reduce and mode through window_select, each held to its plain
   version and to phase 3's host references.  Prints each weight build's
   host stages (``timings.summary()``: the voronoi angle sort and both
   point locations apart), the weights' nnz and w_max, and phase 4's
   apply times at E = 1, 20 and 128 for the barycentric and network
   weights.
8. Labelled arrays and structured grids at the 1M config: phase 3's
   mesh and data as a ``UgridDataArray`` (time=20, face) on the card
   regridded onto a 512 x 512 raster ``DataArray`` (y descending, dx
   and dy) by ``OverlapRegridder`` mean and mode and
   ``RelativeOverlapRegridder``: a DataArray (time, y, x) with the
   raster's coordinates whose payload is a CUDA tensor, one launch,
   held to the plain version and the host references, bit-equal to the
   bare-tensor regrid onto ``Ugrid2d.from_structured_bounds`` of the
   directional bounds (the mean also to the ascending raster flipped,
   at float32 tolerance), and the labelled and bare apply passes timed
   (back to back, host us per call).  A 1000 x 1000 raster (time=20, y
   descending) onto the 512 x 512 raster by overlap mean, relative
   overlap (every source cell's weights sum to 1 within 1e-12),
   ``BarycentricInterpolator`` (bilinear weights; a float32 linear
   field back within rtol 1e-5) and ``CentroidLocatorRegridder`` (no
   launch, bit-equal to numpy's gather), with the weight builds by
   stage and phase 4's apply times.  Phase 5's 1M Delaunay fill of 20
   slices through ``uda.ugrid.laplace_interpolate``: one batched solve
   (csr_matvec's launches), equal to the direct call, phase 5's
   residual gate, on a numpy and a CUDA payload.  Faces of 40 and 120
   nodes over a 40 x 40 quad mesh: overlap areas and mean-value weights
   on the card against the native kernels (40 nodes) and the CPU (120),
   and the OverlapRegridder on the card summing each face's areas to
   its area.
9. UGRID files and stored weights at the 1M config, in a temporary
   directory removed at the end: phase 3's mesh with a (time=20, face)
   float32 payload on the card and a datetime64 time coordinate written
   through ``.ugrid.to_netcdf`` and ``.ugrid.to_zarr`` (the payload
   copied to the host explicitly) and opened with ``xt.open_dataset`` /
   ``xt.open_zarr``: the grid equal, connectivity, node coordinates and
   data bit-equal, MB and write and open seconds printed.
   ``OverlapRegridder`` (mean, mode) and ``BarycentricInterpolator``
   mesh -> 512 x 512 raster, and phase 7's ``NetworkGridder`` (mean),
   each built (timed), stored with ``to_dataset().to_netcdf`` and
   rebuilt with ``from_dataset`` (timed): the weights bit-equal, the
   regrid of the opened data on the card one launch of window_reduce or
   window_select, held to the plain version and the host references and
   bit-equal to the fresh regridder's, its first pass and back-to-back
   pass timed beside the fresh one's.  The mean's raster result written
   with ``to_dataset(...).to_netcdf`` and read back bit-equal.
10. A partitioned run merged and regridded at the 1M config: phase 3's
   mesh as a ``UgridDataset`` with (time=20, face) float32, (edge,) and
   (node,) float64 payloads on the card split by
   ``uds.ugrid.partition(n_part=4)`` (payloads still on the card), each
   partition written as a UGRID netCDF map file in a temporary directory
   removed at the end and opened with ``xt.open_dataset``;
   ``xt.merge_partitions`` of the in-memory partitions (payload on the
   card, still a CUDA tensor after) and of the opened files each gives
   the mesh's node, face and edge counts, and under the original
   positions the merge carried along every face's node coordinates and
   every payload value bit-equal.  Both merged temperatures regridded
   onto phase 3's 512 x 512 raster by ``OverlapRegridder`` mean
   (window_reduce) and median (window_select), one launch per call, held
   to the plain version and the host references; the median bit-equal
   to phase 3's unpartitioned regrid, the mean within rtol 1e-5 and the
   float32 summation bound of the window.  Times the partition (labels,
   subsets, data ``isel``), the files, the merge by stage (nodes, faces,
   edges, data), ``unique_rows`` on the merge's node and face rows
   through the native hash and the torch grouping on the card, and the
   regrid passes.
11. Queries and the nearest fill at the 1M config, through the
   ``.ugrid`` accessor of phase 3's mesh with its (time=20, face) float32
   payload on the card: ``locate_nearest_node``/``_edge``/``_face`` of
   100,000 seeded points (1.0e11 to 2.0e11 pairs: the tiled distance scan
   of ``spatial/nearest.py`` on the card), each equal to scipy's KDTree or
   equidistant within rtol 1e-5 or the float32 scan's resolution (2
   sqrt(2) ulps of its largest shifted coordinate), the scan timed on resident tensors
   (CUDA events, median of 3 after a warm-up) beside the KDTree's build
   and threaded query, also at the threshold shape 32,768 x 2,097,152 =
   2^36 pairs; ``sel_points`` of 10,000 stations (1 % outside) by
   containment, ``method="nearest"`` and on a node payload, bit-equal to
   numpy's gather with NaN outside, on the card; ``intersect_line`` along
   the diagonal, ``sel(x=..., y=slice(None))`` and ``intersect_linestring``
   of a 1,000-vertex random walk, every face holding its sub-segment's
   midpoint (native point location), ``s`` non-decreasing, values
   bit-equal; ``rasterize_like`` onto the 512 x 512 raster and
   ``rasterize(resolution)``, bit-equal to the host gather and to phase
   7's ``CentroidLocatorRegridder`` wherever both located a face;
   ``interpolate_na`` of a (time=4, face) payload with 10 % NaN in seeded
   patches (the card scan, about 100,000 queries against 900,000 known
   faces per slice), each fill the value of the KDTree's nearest known
   face or an equidistant one, then regridded onto the raster by
   ``OverlapRegridder`` mean (one window_reduce launch, held to the plain
   version and the host reference); ``to_node``/``to_edge``/``to_face``
   bit-equal to numpy's gather on the card, and ``reindex_like`` of a
   shuffled copy of the mesh bit-equal to the original; on phase 7's
   network ``sel_points`` onto its edges, ``intersect_line`` across it and
   ``interpolate_na`` of 10 % NaN node data by Dijkstra, bit-equal to
   scipy's ``dijkstra`` called directly.
12. The topology operations at the 1M config, each result held to a host
   computation written here from the arrays: ``triangulate()`` and
   ``triangulation`` (the first-node fans, 2,000,000 triangles whose
   areas sum to each face's within 1e-12 relative), ``exterior_edges``
   and ``exterior_faces`` (the sides held by one face), ``perimeter``,
   ``face_bounds``, ``edge_bounds``, ``face_node_coordinates``,
   ``validate_edge_node_connectivity``; ``tesselate_centroidal_voronoi``
   of the mesh and ``tesselate_circumcenter_voronoi`` of its
   triangulation with the angle sort on the card, equal to the CPU's in
   every array but rows of angle ties (same vertices, angles within
   1e-12, areas within 1e-9 relative), then the mesh regridded onto the
   centroidal dual by ``OverlapRegridder`` mean (window_reduce);
   ``binary_dilation`` and ``binary_erosion`` (5 iterations, with and
   without a mask, both border values) of the wet faces (phase 11's
   patches dry) as a bool payload on the card, bit-equal to
   scipy.ndimage step by step, the eroded faces taken with ``isel``,
   their ``connected_components`` equal to scipy's and regridded by mode
   onto the raster (window_select); ``reverse_cuthill_mckee`` with the
   (time=20, face) payload, bit-equal to the payload in the new order,
   regridded by mean (window_reduce) within the float32 summation bound
   of phase 3's regrid; ``to_periodic`` of node, edge and face payloads
   on the card (1,001 fewer nodes, 1,000 fewer edges), a Laplace fill of
   the periodic nodes through the accessor (csr_matvec; phase 5's 2 %
   known, every residual within 10 atol in scipy float64), and
   ``to_nonperiodic`` back (the face payload bit-equal, node and edge
   payloads bit-equal but at x = 1000, which carries the x = 0
   survivor's); on phase 7's network ``is_cyclic`` against Kahn's
   algorithm, ``topological_sort_by_dfs``, ``contract_vertices``,
   ``refine_by_vertices`` and ``remove_self_loops``.  Prints the back-to-
   back overlap mean pass in the original and the reordered face order.
13. The payload methods of labelled arrays at the 1M config: phase 3's
   mesh with a (time=20, face) float32 ``UgridDataset`` of two variables
   (1 % NaN, one with half-step ties) and an uneven time coordinate on
   the card.  ``mean``, ``std``, ``median``, ``quantile([0.1, 0.9])`` and
   ``count`` over time; ``cumsum``, ``diff``, ``shift``, ``roll``,
   ``ffill``/``bfill`` with a limit, ``interpolate_na``, ``rank``,
   ``idxmax``, ``clip``, ``round``, ``isin``, ``where(drop=True)`` over
   the faces, ``fillna``, ``sortby`` and ``reindex`` on time, ``dot``
   with a (time,) weight vector (TF32 allowed globally) and
   ``to_dataframe`` of 10,000 faces.  Each result a tensor on the card,
   held to a host reference (numpy, scipy's ``rankdata``, pandas'
   ``ffill``/``bfill``, ``np.interp``): bit-equal, or within the float32
   summation bound (mean, cumsum, dot), rtol 1e-5 (std), 1e-6 (median),
   float64 rtol 1e-12 (quantile, interpolate_na), 1 ulp (round); each
   timed (CUDA events; wall seconds for the host-bound ones).  The
   time-mean regridded onto the 512 x 512 raster by phase 3's overlap
   mean (window_reduce) and the (quantile=2, face) stack by its median
   (window_select), one launch each, held to the plain version and the
   host references; ``OverlapRegridder.from_weights(r.weights, target)``
   regrids bit-equal in one launch.  Phase 7's network with node data 2 %
   known and one line without a known node filled through
   ``.ugrid.laplace_interpolate``: csr_matvec's launches the formula's,
   that line NaN, every other line's residual within 10 atol (scipy,
   float64).

14. Vector geometry and the sample data at the 1M config: the stand-in
   ``provinces_nl()`` (12 rings of 24 vertices) mapped onto phase 3's mesh
   by one affine map keeping the aspect ratio, a 13th ring with a hole,
   ``hydamo_network()``'s 9 channels and 18 gauges mapped by the affine
   map of their bounding box; shapely and geopandas where installed, else
   the numpy stand-ins of ``tests/fake_geo.py`` placed in ``sys.modules``.
   ``burn_vector_geometry`` of all of them by ``id`` (``all_touched``
   False and True) and by ``depth``: every polygon face equal to an
   even-odd ray cast of the centroids (faces within the tolerance of an
   edge exempt and counted), every channel face crossed by its channel,
   every gauge in its face, the all_touched set a superset; the stages
   timed (earcut, the candidate pairs and the overlap clip, the centroid
   test).  The ids regridded onto the 512 x 512 raster by phase 3's mode
   (window_select) and the depth by its mean (window_reduce), each held
   to the plain version and the host references; ``polygonize`` of the
   ids: as many polygons as scipy's components of equal-valued faces,
   each of its region's value, every ring whose region's boundary has no
   pinch vertex of the area of its faces plus its holes within 1e-9
   (regions with a pinch counted); ``earcut_triangulate_polygons`` of the
   provinces onto the 1M mesh by mode (window_select), equal to the
   burned ids on every face wholly inside one province; ``snap_to_grid``
   of the channels at half a face: every edge within reach of its
   channel, each channel's edges one path, then ``Ugrid1d.
   from_geodataframe``, the gauges on their nearest nodes filled through
   ``.ugrid.laplace_interpolate`` (csr_matvec: the formula's launches,
   every component's residual within 10 atol); ``to_geodataframe`` of
   10,000 faces of phase 13's payload and ``Ugrid2d.from_geodataframe``
   back (node coordinates bit-equal), ``bounding_polygon`` (the mesh's
   area within 1e-9) and ``snap_nodes`` of 10,000 node copies jittered by
   1e-6 (each onto its original).  Wall seconds per step.
15. The XL config (``bench.py``'s 3163 x 3163 jittered quads, 10,004,569
   faces, onto a 1024 x 1024 raster ``DataArray``) streamed from files:
   ``OverlapRegridder`` mean and median built (host stages, nnz against
   bench.py's 18,166,177, w_max), applied in memory at E = 20 (one launch
   each, held to the plain version and to host references on 2 slices;
   kernel, bound, plain and library times: ``torch.sparse.mm`` for the
   mean, ``torch.nanquantile`` over the gathered windows for the median);
   an hourly (time,
   face) float32 payload with 1 % NaN and an int16 packed with
   scale_factor, add_offset and _FillValue written through
   ``.ugrid.to_netcdf`` (29 hours: the classic format's 2^31-byte
   offsets) and ``.ugrid.to_zarr`` (48 hours of the float32, 1.92 GB) in
   a temporary directory removed at the end, opened with ``lazy=True``
   and each lazy payload regridded by mean and by median under the default
   ``APPLY_CHUNK_BYTES``: one launch per block (each file in more than
   one block), read and decode, host-to-device and kernel times per
   block, the card's peak allocation within the budget plus the weights
   and the result, every block read within the budget (and under half
   the variable where the budget allows it), bit-equal to the eager
   regrid of the payload written; ``isel(time=slice(0, 24))`` lazy,
   reading just its rows.  ``resample``, ``groupby``, ``rolling``,
   ``coarsen``, ``weighted``, ``polyfit``, ``interp``, ``differentiate``,
   ``integrate`` and ``stack``/``unstack`` on the first 48 hours of the
   streamed zarr mean, each on the card, held to the same method on a CPU
   copy and to a numpy formula; phase 13's payload resampled (mean) and
   grouped (median) and regridded through phase 3's mean and median.

16. Curvilinear and 3-D structured grids, the sharded regrid and CG, and
   the profiler hooks: a 1000 x 1000 curvilinear ocean grid (rotated,
   warped, 10 % land) as (N, M, 4) corner bounds with (time=20) float32
   data on the card through ``UgridDataArray.from_structured2d(x_bounds=,
   y_bounds=)`` onto phase 3's 1M mesh by ``OverlapRegridder`` mean
   (window_reduce) and mode (window_select); voxels (40, 500, 500) and a
   40-layer model of varying thickness per column over 500 x 500
   (``StructuredGrid3d``, ``ExplicitStructuredGrid3d``) onto (20, 250,
   250) voxels through ``PaddedCSR.from_coo`` and ``apply_weights`` mean
   at E = 1 and 4; phase 3's mean weights in Hilbert order through
   ``ShardedRegrid`` halo and allgather (mean, median, E = 20), phase 5's
   unknown system through ``sharded_cg_solve`` (csr_matvec) and the mesh's
   faces through ``sharded_laplace_smooth``, in a world of 1 (NCCL, in this
   process) and of 2 (gloo, ``--sharded-rank`` processes spawned on this
   card); one apply under ``trace()``/``annotate()`` in a process of its
   own.  Each result held to the plain version and a host computation,
   the sharded ones bit-equal to the unsharded apply.

17. The flat BVH and its batched queries (``spatial/queries.py``, torch
   ops) at full width: ``build_bvh`` over phase 3's 1M face boxes (the
   native kd order and the numpy branch timed), point location of
   1,000,000 points (frontier descent, overflows rerun by the skip-link
   walk) against ``CellTree2d.locate_points``, the 512 x 512 raster's cell
   boxes by the frontier join and by count then emit against the grid
   hash, 100,000 points on phase 7's network against
   ``EdgeCellTree2d.locate_points``, and the exact passes (point in
   polygon, segment clip, burn centroids in triangles) against the native
   host kernels; ms per pass beside the native library's seconds; no
   CUDA kernel launches.  ``uda.ugrid.plot()`` of a CUDA payload raises
   without matplotlib (the card machine has none).

Prints one JSON line describing the kernels, then, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises (non-zero exit);
without a CUDA device it exits with 2 and prints no result.

``--sharded-rank RANK WORLD DIR DEVICE`` is one rank of phase 16's
spawned world, and ``--traced-apply DIR DEVICE`` phase 16's traced apply
(the script starts them itself).

``--compare LABEL`` runs only ``phase_compare``: the regrid apply pass
(mean, first_order_conservative, median, mode) and csr_matvec at the 1M
configs, timed in the same ways through the
entry points that every version of the port has (``apply_weights``,
``csr_matvec``), each line tagged LABEL.  Copied into another checkout
of the port and run from its root, it times that version the same way,
so two versions compare in one chip call.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

N_SIDE, T_SIDE, N_EXTRA = 1000, 512, 20
TIMING_EXTRAS = (1, 20, 128)
LAPLACE_SIDE, LAPLACE_SLICES = 1000, 20
LAPLACE_SOLVE = {"atol": 1e-6, "rtol": 0.0, "maxiter": 2000}
#: Peak rates outside the tensor cores of an H100 SXM at 700 W (NVIDIA's
#: data sheet): 67 TFLOP/s float32, 34 TFLOP/s float64.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


def quad_mesh(nx, ny, dx=1.0):
    """Nodes and (n, 4) faces of an nx by ny quad mesh of cell size dx."""
    x = np.arange(nx + 1.0) * dx
    y = np.arange(ny + 1.0) * dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    nid = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1
    ).reshape(-1, 4)
    return verts, faces


def bench_meshes(n_side, t_side, rng):
    """The bench config's meshes: an n_side^2 quad mesh with interior
    nodes jittered by +-0.15, and a t_side^2 raster over the same extent."""
    verts, faces = quad_mesh(n_side, n_side)
    jitter = rng.uniform(-0.15, 0.15, verts.shape)
    edge = (
        (verts[:, 0] == 0) | (verts[:, 1] == 0)
        | (verts[:, 0] == n_side) | (verts[:, 1] == n_side)
    )
    jitter[edge] = 0.0
    verts = verts + jitter
    tverts, tfaces = quad_mesh(t_side, t_side, dx=n_side / t_side)
    return (verts, faces), (tverts, tfaces)


def random_network(n_lines, n_segments, extent, rng):
    """``n_lines`` random-walk polylines of ``n_segments`` segments each,
    every segment 0.5 to 1.5 long, inside [0, extent]^2: the heading
    drifts by a normal step of 0.3 rad per segment and turns back where
    a step would leave the domain.  Returns (nodes (n, 2), edges (e, 2))."""
    pos = rng.uniform(0.05 * extent, 0.95 * extent, (n_lines, 2))
    heading = rng.uniform(-np.pi, np.pi, n_lines)
    nodes = [pos]
    for _ in range(n_segments):
        heading = heading + rng.normal(0.0, 0.3, n_lines)
        step = rng.uniform(0.5, 1.5, n_lines)
        nxt = pos + step[:, None] * np.column_stack([np.cos(heading), np.sin(heading)])
        out = ((nxt < 0.0) | (nxt > extent)).any(axis=1)
        heading = np.where(out, heading + np.pi, heading)
        nxt = np.where(out[:, None], pos - (nxt - pos), nxt)
        pos = np.clip(nxt, 0.0, extent)
        nodes.append(pos)
    nodes = np.stack(nodes, axis=1)  # (n_lines, n_segments + 1, 2)
    first = np.arange(n_lines)[:, None] * (n_segments + 1) + np.arange(n_segments)[None, :]
    edges = np.stack([first, first + 1], axis=-1).reshape(-1, 2)
    return nodes.reshape(-1, 2), edges


def delaunay_mesh(n_side, seed=11):
    """(n_side + 1)^2 uniform random points on [0, 100)^2, triangulated
    by scipy's Delaunay, with the node order shuffled so that no
    incidental bandedness survives (``scripts/laplace_scale_demo.py``'s
    ``LAPLACE_MESH=delaunay``).  Returns (nodes (n, 2), faces (f, 3))."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    n_pts = (n_side + 1) ** 2
    pts = rng.uniform(0.0, 100.0, (n_pts, 2))
    tri = Delaunay(pts)
    perm = rng.permutation(n_pts)
    inv = np.empty(n_pts, np.int64)
    inv[perm] = np.arange(n_pts)
    return pts[perm], inv[tri.simplices]


def structured_triangle_mesh(n_side):
    """An n_side x n_side quad raster over [0, 100]^2, each quad split
    into two triangles fanned from its first node: a structured-derived
    mesh, whose node graph is banded (the JAX package gives it its DIA
    stencil solver)."""
    verts, quads = quad_mesh(n_side, n_side, dx=100.0 / n_side)
    faces = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
    return verts, faces


def laplace_inputs(nodes, known_fraction=0.02, seed=7):
    """The scale demo's fill problem: the truth field sin(x / 17) *
    cos(y / 23) * 10 + 5, known at a random ``known_fraction`` of the
    nodes.  Returns (truth, values with NaN at the unknowns)."""
    rng = np.random.default_rng(seed)
    truth = np.sin(nodes[:, 0] / 17.0) * np.cos(nodes[:, 1] / 23.0) * 10.0 + 5.0
    known = rng.random(len(nodes)) < known_fraction
    return truth, np.where(known, truth, np.nan)


def synthetic_windows(rng, n=4000, m=3000, w=40, n_extra=6):
    """PaddedCSR-style windows and two sources for the kernel checks.

    Windows are ragged (1-12 slots, 5 % of them 33-40 slots), 2 % are
    empty, 2 % have only zero weights, and 5 % of the slots have weight
    zero.  The mixed source is normal (half of it rounded to 0.5 steps,
    so windows hold equal values) with 10 % NaN, 1 % +inf, 1 % -inf and
    5 % zeros; the positive source is its absolute value."""
    base = (np.arange(n) * m) // n
    indices = np.clip(base[:, None] + rng.integers(-20, 21, size=(n, w)), 0, m - 1)
    widths = rng.integers(1, 13, size=n)
    wide = rng.random(n) < 0.05
    widths[wide] = rng.integers(33, w + 1, size=int(wide.sum()))
    in_window = np.arange(w)[None, :] < widths[:, None]
    indices = np.where(in_window, indices, -1).astype(np.int32)
    indices[rng.random(n) < 0.02] = -1
    weights = rng.uniform(0.1, 2.0, size=(n, w))
    weights[rng.random((n, w)) < 0.05] = 0.0
    weights[rng.random(n) < 0.02] = 0.0
    weights[indices < 0] = 0.0
    source = rng.normal(size=(n_extra, m))
    source[:, : m // 2] = np.round(source[:, : m // 2] * 2.0) / 2.0
    u = rng.random(source.shape)
    source[u < 0.10] = np.nan
    source[(u >= 0.10) & (u < 0.11)] = np.inf
    source[(u >= 0.11) & (u < 0.12)] = -np.inf
    source[(u >= 0.12) & (u < 0.17)] = 0.0
    return indices, weights, source, np.abs(source)


def synthetic_csr(rng, n=5000, m=4000, max_row=40):
    """A CSR matrix for the matvec checks: rows of 0 to ``max_row``
    entries, 10 % of them empty, normal weights (negative ones
    included) with 10 % exact zeros.  Returns (indptr int32, indices
    int32, data float64)."""
    lengths = rng.integers(0, max_row + 1, n)
    lengths[rng.random(n) < 0.10] = 0
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(lengths, out=indptr[1:])
    indices = rng.integers(0, m, int(indptr[-1])).astype(np.int32)
    data = rng.normal(size=int(indptr[-1]))
    data[rng.random(len(data)) < 0.10] = 0.0
    return indptr, indices, data


def compare(got, want, exact, rtol, atol):
    """Hold ``got`` to ``want``: the same NaN and inf positions, finite
    values bit-equal (``exact``) or within atol + rtol * |want| (``atol``
    a number, or a tensor of the shape of ``want``).
    Returns the largest absolute difference of the finite values."""
    import torch

    g = got.double().cpu()
    w = want.double().cpu()
    if g.shape != w.shape:
        raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.equal(torch.isnan(g), torch.isnan(w)):
        raise AssertionError(f"NaN masks differ at {int((torch.isnan(g) != torch.isnan(w)).sum())} outputs")
    if not torch.equal(torch.isinf(g), torch.isinf(w)) or not torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]):
        raise AssertionError("inf positions or signs differ")
    finite = torch.isfinite(w)
    err = (g[finite] - w[finite]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if exact:
        if max_err != 0.0:
            raise AssertionError(f"not bit-equal: max |diff| {max_err}")
    else:
        if isinstance(atol, torch.Tensor):
            atol = atol.double().cpu()[finite]
        bad = err > atol + rtol * w[finite].abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{int(bad.sum())} outputs beyond rtol {rtol} / atol {atol}: max |diff| {max_err}"
            )
    return max_err


def tolerance(dtype, scale):
    """(rtol, atol) of a kernel against its plain version: float32 at
    rtol 1e-5 / atol 1e-6 * max|source|, float64 at rtol 1e-12 / atol
    1e-12 * max|source|.  The two sum in different orders, so a result
    that cancels to near zero keeps only an absolute agreement."""
    import torch

    if dtype == torch.float32:
        return 1e-5, 1e-6 * scale
    return 1e-12, 1e-12 * scale


def summation_bound(source, idx, w, fn):
    """Order-independent error bound of a window sum of up to w_max
    terms over the (E, m) source: w_max * unit roundoff * (the same
    reduction of |source|), (E, n).  Wide windows of mixed signs can
    cancel below the fixed atol."""
    import torch

    from xugrid_tpu_torch.regrid import reduce

    unit = 2.0**-24 if source.dtype == torch.float32 else 2.0**-53
    magnitude = reduce.reduce_windows(source.abs().t(), idx, w, fn).t()
    return idx.shape[1] * unit * magnitude


def tile_block_reduce(source, idx, wt, fn):
    """window_reduce of ``fn`` through ``reduce_lanes``' tile block
    whatever the window width: the launch that row tiles replace for
    windows of at most ROW_TILE_SLOTS slots.  Returns a new (E, n)
    tensor; raises on a CUDA error."""
    import torch

    from xugrid_tpu_torch.regrid.aligned_apply import DTYPE_CODES, METHOD_CODES, kernel_function, reduce_lanes

    (E, m), (n, w) = source.shape, idx.shape
    out = torch.empty((E, n), dtype=source.dtype, device=source.device)
    slice_warps, target_warps, staged = reduce_lanes(E, w, source.element_size())
    err = kernel_function("xt_window_reduce")(
        DTYPE_CODES[source.dtype], METHOD_CODES[fn], source.data_ptr(), idx.data_ptr(), wt.data_ptr(),
        out.data_ptr(), n, m, w, E, slice_warps, target_warps, int(staged),
        torch.cuda.current_stream(source.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"xt_window_reduce failed with CUDA error {err}")
    return out


def same_bits(a, b) -> bool:
    """True when two float tensors hold the same bits, NaN included."""
    import torch

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_build():
    import torch

    from xugrid_tpu_torch.utils import build, native

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.kernel_library()
    t1 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build")
    t2 = time.perf_counter()
    print(f"build: CUDA kernels {t1 - t0:.3f} s, host library {t2 - t1:.3f} s")
    log = (build.BUILD_DIR / "kernels.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return log


#: window_select's kinds in the order of their codes (``SelectKind`` in
#: csrc/window_select.cu).
SELECT_KIND_NAMES = ("percentile", "mode", "median")


def check_select_registers(log):
    """Every window_select instantiation keeps its window in registers:
    ptxas reports no stack frame and no spill bytes (a register array
    indexed at run time would land in local memory).  Prints one line
    per instantiation; raises otherwise."""
    import re

    entries = re.findall(
        r"Function properties for (\S*window_select_kernelI([fd])Li([012])ELi(\d+)ELb([01])E\S*)\s*\n"
        r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s*\n"
        r".*?Used (\d+) registers",
        log,
    )
    if len(entries) != 2 * 3 * 3 * 2:
        raise AssertionError(f"expected 36 window_select instantiations in the ptxas report, found {len(entries)}")
    bad = []
    for _, dtype, kind, slots, staged, stack, stores, loads, regs in entries:
        name = (
            f"window_select<{'float' if dtype == 'f' else 'double'}, {SELECT_KIND_NAMES[int(kind)]}, "
            f"K={slots}, {'staged' if staged == '1' else 'in place'}>"
        )
        print(f"  {name}: {regs} registers, {stack} bytes stack, {stores} / {loads} bytes spill stores / loads")
        if int(stack) or int(stores) or int(loads):
            bad.append(name)
    if bad:
        raise AssertionError(f"window_select instantiations use local memory: {bad}")


#: window_reduce's methods in the order of their codes (``ReduceMethod``
#: in csrc/window_reduce.cu, ``METHOD_CODES`` in aligned_apply.py).
REDUCE_METHOD_NAMES = (
    "mean", "sum", "first_order_conservative", "harmonic_mean", "geometric_mean", "minimum", "maximum",
    "max_overlap",
)


def check_reduce_registers(log):
    """Name every instantiation of window_reduce.cu's three kernels,
    ``window_reduce_kernel<T, M, STAGED, B>`` (2 types x 8 methods x 4
    (staged, B) pairs), ``window_reduce_kernel_rows<T, M, W, VEC>`` (2
    types x 8 methods x W = 1, 2, 4 x 16-byte or single stores) and
    ``csr_matvec_kernel<T>`` (2 types), by their mangled names in the
    ptxas report, and print its registers, stack frame and spill bytes.
    Raises only when the report does not hold the 162 instantiations.
    Returns {name: (registers, stack, spill stores, spill loads)}."""
    import re

    properties = (
        r"\s*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads\s*\n"
        r".*?Used (\d+) registers"
    )
    reduce_entries = re.findall(
        r"Function properties for \S*window_reduce_kernelI([fd])Li(\d+)ELb([01])ELi(\d+)E\S*" + properties, log
    )
    rows_entries = re.findall(
        r"Function properties for \S*window_reduce_kernel_rowsI([fd])Li(\d+)ELi(\d+)ELb([01])E\S*" + properties, log
    )
    matvec_entries = re.findall(r"Function properties for \S*csr_matvec_kernelI([fd])E\S*" + properties, log)
    if len(reduce_entries) != 2 * 8 * 4 or len(rows_entries) != 2 * 8 * 3 * 2 or len(matvec_entries) != 2:
        raise AssertionError(
            f"expected 64 window_reduce_kernel, 96 window_reduce_kernel_rows and 2 csr_matvec_kernel "
            f"instantiations in the ptxas report, found {len(reduce_entries)}, {len(rows_entries)} and "
            f"{len(matvec_entries)}"
        )
    found = {}
    for dtype, method, staged, batch, stack, stores, loads, regs in reduce_entries:
        name = reduce_build_name(
            "float32" if dtype == "f" else "float64", REDUCE_METHOD_NAMES[int(method)], staged == "1", int(batch)
        )
        found[name] = (int(regs), int(stack), int(stores), int(loads))
    for dtype, method, slots, vec, stack, stores, loads, regs in rows_entries:
        name = rows_build_name(
            "float32" if dtype == "f" else "float64", REDUCE_METHOD_NAMES[int(method)], int(slots), vec == "1"
        )
        found[name] = (int(regs), int(stack), int(stores), int(loads))
    for dtype, stack, stores, loads, regs in matvec_entries:
        name = f"csr_matvec_kernel<{'float' if dtype == 'f' else 'double'}>"
        found[name] = (int(regs), int(stack), int(stores), int(loads))
    for name, (regs, stack, stores, loads) in found.items():
        spills = "  SPILLS" if stack or stores or loads else ""
        print(f"  {name}: {regs} registers, {stack} bytes stack, {stores} / {loads} bytes spill stores / loads{spills}")
    spilling = [name for name, (_, stack, stores, loads) in found.items() if stack or stores or loads]
    print(f"  window_reduce.cu builds with a stack frame or spills: {spilling or 'none'}")
    return found


def reduce_build_name(dtype: str, method: str, staged: bool, batch: int) -> str:
    """The name ``check_reduce_registers`` gives one window_reduce_kernel
    instantiation."""
    return (
        f"window_reduce_kernel<{'float' if dtype == 'float32' else 'double'}, {method}, "
        f"{'staged' if staged else 'in place'}, B={batch}>"
    )


def rows_build_name(dtype: str, method: str, slots: int, vec: bool) -> str:
    """The name ``check_reduce_registers`` gives one
    window_reduce_kernel_rows instantiation."""
    return (
        f"window_reduce_kernel_rows<{'float' if dtype == 'float32' else 'double'}, {method}, W={slots}, "
        f"{'16-byte' if vec else 'single'} stores>"
    )


def launched_reduce_build(dtype: str, method: str, E: int, w: int) -> str:
    """The window_reduce_kernel instantiation that a launch over E slices
    and windows of w > ROW_TILE_SLOTS slots takes: the wrapper's
    ``reduce_lanes`` block, then launch_batched's B (4 when staged, else
    from the slices per warp)."""
    from xugrid_tpu_torch.regrid.aligned_apply import reduce_lanes

    slice_warps, _, staged = reduce_lanes(E, w, 4 if dtype == "float32" else 8)
    per_warp = -(-E // slice_warps)
    batch = 4 if staged or per_warp >= 4 else (2 if per_warp >= 2 else 1)
    return reduce_build_name(dtype, method, staged, batch)


def report_main_path_builds(registers, w):
    """Which window_reduce.cu instantiations the 1M mean and
    first_order_conservative applies (E = 1 and N_EXTRA, float32, w
    slots) and the float64 csr_matvec launch, with their registers and
    spills."""
    builds = {
        f"{method} E={E}": launched_reduce_build("float32", method, E, w)
        for method in ("mean", "first_order_conservative") for E in (1, N_EXTRA)
    }
    builds["csr_matvec float64"] = "csr_matvec_kernel<double>"
    for label, name in builds.items():
        regs, stack, stores, loads = registers[name]
        print(
            f"  the 1M {label} launches {name}: {regs} registers, {stack} bytes stack, "
            f"{stores} / {loads} bytes spill stores / loads"
        )
    return builds


#: Phase 2's slice counts: window_reduce's slice-warp count S of
#: ``reduce_lanes`` (1, 1, 1, 2, 4, 8) and slice batch (1, 2, 4, 4, 4, 4);
#: window_select's S (1, 1, 4, 8, 8, 8), in place at E = 1 and staged
#: above.
CHECK_EXTRAS = (1, 3, 20, 40, 128, 200)
#: Phase 2's window tables: the first n = 4001 windows of 40 slots cut to
#: 8, 16 and 32 slots (window_select's register slots K = 8, 16, 32, no
#: walk) and whole (K = 32, the 5 % of 33-40 slots walk); and 300
#: windows of up to 400 slots, which fit no tile's shared memory and of
#: which 5 % walk.
CHECK_WIDTHS = {40: (8, 16, 32, 40), 400: (400,)}
#: Phase 2's row tiles: the first 1 to 4 slots of the 40-slot windows, on
#: n = 4001 targets (single stores) and the first 4000 (16-byte stores).
ROW_WIDTHS = (1, 2, 3, 4)


def phase_kernel_checks(device):
    """Phase 2: every method of both window kernels against the plain
    version, at each lane mapping window_reduce's wrapper picks and at
    each register array and the walk of window_select."""
    import torch

    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import METHOD_CODES, reduce_lanes, row_tiles, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import register_slots, window_select

    percentiles = [reduce.Percentile(p) for p in (0, 5, 25, 50, 75, 95, 100, 33.3)]
    # Selections, mode and percentiles run the same arithmetic in the
    # same order in kernel and plain version, so they are held bit for
    # bit.  harmonic_mean runs on the positive source only: with mixed
    # signs its sum of w / v cancels without a bound that the summation
    # order leaves alone.
    exact = {reduce.minimum, reduce.maximum, reduce.max_overlap, reduce.mode, *percentiles}
    linear = {reduce.mean, reduce.sum, reduce.first_order_conservative}
    rng = np.random.default_rng(7)
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    plans = set()
    # n = 4001 is a multiple of no tile (32 to 256 targets); 2 % of the
    # windows are all pad.
    for n, w in ((4001, 40), (300, 400)):
        indices, weights, mixed, positive = synthetic_windows(rng, n=n, w=w, n_extra=max(CHECK_EXTRAS))
        print(f"phase 2: windows n={n} w_max={w}, sources (E, m)={mixed.shape}")
        for dtype in (torch.float32, torch.float64):
            idx = torch.from_numpy(indices).to(device)
            wt = torch.from_numpy(weights).to(device=device, dtype=dtype)
            for label, src in (("mixed", mixed), ("positive", positive)):
                scale = float(np.nanmax(np.abs(np.where(np.isfinite(src), src, np.nan))))
                rtol, atol = tolerance(dtype, scale)
                for E in CHECK_EXTRAS:
                    source = torch.from_numpy(src[:E].copy()).to(device=device, dtype=dtype)
                    plan = reduce_lanes(E, w, source.element_size())
                    plans.add(plan)
                    errs = []
                    for fn in METHOD_CODES:
                        if fn is reduce.harmonic_mean and label == "mixed":
                            continue
                        got = window_reduce(source, idx, wt, fn)
                        want = reduce.reduce_windows(source.t(), idx, wt, fn).t()
                        bound = atol
                        if fn in linear:
                            bound = torch.clamp(summation_bound(source, idx, wt, fn), min=atol)
                        torch.cuda.synchronize()
                        errs.append(compare(got, want, fn in exact, rtol, bound))
                    max_err["window_reduce"] = max(max_err["window_reduce"], *errs)
                    print(
                        f"  window_reduce {label} {str(dtype)[6:]} E={E} (slice warps, target warps, "
                        f"staged) {plan}: all methods ok, max |diff| {max(errs):.3e}"
                    )
                    for width in ROW_WIDTHS if w == 40 else ():
                        for rows in (n, n - 1):
                            cut_idx, cut_wt = idx[:rows, :width].contiguous(), wt[:rows, :width].contiguous()
                            for fn in METHOD_CODES:
                                if fn is reduce.harmonic_mean and label == "mixed":
                                    continue
                                got = window_reduce(source, cut_idx, cut_wt, fn)
                                if not same_bits(got, tile_block_reduce(source, cut_idx, cut_wt, fn)):
                                    raise AssertionError(f"row tiles differ from the tile block: {fn.__name__}")
                                want = reduce.reduce_windows(source.t(), cut_idx, cut_wt, fn).t()
                                bound = atol
                                if fn in linear:
                                    bound = torch.clamp(summation_bound(source, cut_idx, cut_wt, fn), min=atol)
                                torch.cuda.synchronize()
                                compare(got, want, fn in exact, rtol, bound)
                            plans.add(("row tiles", width, rows % 4 == 0))
                    if w == 40:
                        print(
                            f"  window_reduce {label} {str(dtype)[6:]} E={E} w=1-4 row tiles "
                            f"{row_tiles(E, n, source.element_size())}: all methods ok, bits of the tile block"
                        )
                    for width in CHECK_WIDTHS[w]:
                        cut_idx, cut_wt = idx[:, :width].contiguous(), wt[:, :width].contiguous()
                        for fn in (reduce.mode, *percentiles):
                            got = window_select(source, cut_idx, cut_wt, fn)
                            want = reduce.reduce_windows(source.t(), cut_idx, cut_wt, fn).t()
                            torch.cuda.synchronize()
                            if got.shape != (E, n) or not got.is_contiguous():
                                raise AssertionError(f"window_select returned {tuple(got.shape)}")
                            compare(got, want, True, 0.0, 0.0)
                        print(
                            f"  window_select {label} {str(dtype)[6:]} E={E} w={width} K={register_slots(width)} "
                            f"(slice warps, target warps, staged) "
                            f"{reduce_lanes(E, width, source.element_size(), batch=1)}: mode and "
                            f"{len(percentiles)} percentiles bit-equal"
                        )
    print(f"  window_reduce mappings checked: {sorted(plans, key=str)}")
    return max_err


#: Phase 2's csr_matvec right-hand-side counts.
MATVEC_EXTRAS = (1, 2, 3, 8, 20)


def phase_matvec_checks(device):
    """Phase 2, csr_matvec: against its plain version, bit for bit, on
    ragged CSR rows (0 to 40 entries); two launches compared bit for
    bit; and cg_solve's refusal of non-finite right-hand sides."""
    import torch

    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain
    from xugrid_tpu_torch.ugrid.interpolate import cg_solve

    rng = np.random.default_rng(5)
    max_err = 0.0
    indptr, indices, data = synthetic_csr(rng)
    print(f"phase 2: csr_matvec rows n={len(indptr) - 1} nnz={len(data)}, widest {int(np.diff(indptr).max())}")
    for dtype in (torch.float32, torch.float64):
        tables = [torch.from_numpy(a).to(device) for a in (indptr, indices)]
        d = torch.from_numpy(data).to(device=device, dtype=dtype)
        for E in MATVEC_EXTRAS:
            x = torch.from_numpy(rng.normal(size=(4000, E))).to(device=device, dtype=dtype)
            got = csr_matvec(*tables, d, x)
            again = csr_matvec(*tables, d, x)
            want = csr_matvec_plain(*tables, d, x)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"csr_matvec E={E}: two launches differ")
            max_err = max(max_err, compare(got, want, True, 0.0, 0.0))
            print(f"  csr_matvec {str(dtype)[6:]} E={E}: bit-equal to plain, deterministic")
    n = 10
    rows = np.concatenate([np.arange(1, n), np.arange(n - 1), np.arange(n)])
    cols = np.concatenate([np.arange(n - 1), np.arange(1, n), np.arange(n)])
    vals = np.concatenate([-np.ones(2 * n - 2), np.full(n, 3.0)])
    for bad in (np.nan, np.inf):
        b = np.ones(n)
        b[4] = bad
        try:
            cg_solve(rows, cols, vals, np.full(n, 3.0), b, np.zeros(n), 0.0, 1e-8, 50)
        except ValueError as e:
            print(f"  cg_solve refuses b with {bad}: {e}")
        else:
            raise AssertionError(f"cg_solve accepted a right-hand side holding {bad}")
    return max_err


def reference_linear(csr, source, relative):
    """Independent host reference of mean (relative=False) and
    first_order_conservative (relative=True): scipy CSR products in
    float64, NaN sources masked out."""
    from scipy.sparse import csr_matrix

    W = csr_matrix((csr.data, csr.indices, csr.indptr), shape=(csr.n, csr.m))
    x = source.astype(np.float64).T
    valid = ~np.isnan(x)
    num = W @ np.where(valid, x, 0.0)
    den = W @ valid.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = num if relative else num / den
    return np.where(den != 0.0, out, np.nan).T


def reference_select(csr, source, targets, method):
    """Independent host reference of median and mode for ``targets``:
    numpy percentiles (linear interpolation) and weighted modes with
    ties to the largest value.  Returns (E, len(targets))."""
    out = np.full((source.shape[0], len(targets)), np.nan)
    for col, t in enumerate(targets):
        lo, hi = csr.indptr[t], csr.indptr[t + 1]
        if hi == lo:
            continue
        cols, wts = csr.indices[lo:hi], csr.data[lo:hi]
        for e in range(source.shape[0]):
            vals = source[e, cols].astype(np.float64)
            ok = ~np.isnan(vals)
            if method == "median":
                if ok.any() and wts.max() > 0:
                    out[e, col] = np.percentile(vals[ok], 50.0)
            elif ok.any() and wts[ok].max() > 0:
                uniq = np.unique(vals[ok])
                totals = np.array([wts[ok][vals[ok] == u].sum() for u in uniq])
                out[e, col] = uniq[totals == totals.max()].max()
    return out


def phase_main_path(device):
    """Phase 3: the overlap regridders at the 1M-face config."""
    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.apply import device_weights
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.utils.profiling import timings

    rng = np.random.default_rng(42)
    t0 = time.perf_counter()
    (verts, faces), (tverts, tfaces) = bench_meshes(N_SIDE, T_SIDE, rng)
    source_grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target_grid = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    print(f"phase 3: meshes {source_grid.n_face} -> {target_grid.n_face} faces in {time.perf_counter() - t0:.3f} s")
    data = rng.normal(size=(N_EXTRA, source_grid.n_face))
    data = (np.round(data * 2.0) / 2.0).astype(np.float32)
    data[rng.random(data.shape) < 0.01] = np.nan
    source = torch.from_numpy(data).to(device)
    torch.cuda.synchronize()

    runs = [
        (xt.OverlapRegridder, "mean", window_reduce),
        (xt.RelativeOverlapRegridder, "first_order_conservative", window_reduce),
        (xt.OverlapRegridder, "median", window_select),
        (xt.OverlapRegridder, "mode", window_select),
    ]
    kernels = (window_reduce, window_select, csr_matvec)
    results = []
    timings.reset()
    for k in kernels:
        k.launches = 0
    for cls, method, kernel in runs:
        before = {k.__name__: k.launches for k in kernels}
        t0 = time.perf_counter()
        regridder = cls(source_grid, target_grid, method=method)
        t1 = time.perf_counter()
        out = regridder.regrid(source)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
        results.append((cls, method, kernel, regridder, out, rose, t1 - t0, t2 - t1))
    counts = {k.__name__: k.launches for k in kernels}

    print(f"  host weight-build stages: {json.dumps(timings.summary())}")
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    scale = float(np.nanmax(np.abs(data)))
    rtol, atol = tolerance(torch.float32, scale)
    sample = np.sort(rng.choice(target_grid.n_face, size=400, replace=False))
    for cls, method, kernel, regridder, out, rose, build_s, apply_s in results:
        name = kernel.__name__
        if rose[name] < 1 or sum(rose.values()) != rose[name]:
            raise AssertionError(f"{method}: expected launches of {name} only, counters rose by {rose}")
        if tuple(out.shape) != (N_EXTRA, target_grid.n_face) or out.dtype != torch.float32:
            raise AssertionError(f"{method}: output {tuple(out.shape)} {out.dtype}")
        finite = float(torch.isfinite(out).double().mean())
        if finite < 0.99:
            raise AssertionError(f"{method}: only {finite:.4f} of the outputs are finite")
        idx, w = device_weights(regridder._padded, torch.float32, source.device, regridder._device_weights)
        plain = reduce.reduce_windows(source.t().contiguous(), idx, w, regridder._reduction).t()
        exact = kernel is window_select
        err = compare(out, plain, exact, rtol, atol)
        max_err[name] = max(max_err[name], err)
        csr = regridder._weights
        out_np = out.double().cpu().numpy()
        if kernel is window_reduce:
            ref = reference_linear(csr, data, relative=method != "mean")
            ref_err = compare(torch.from_numpy(out_np), torch.from_numpy(ref), False, 1e-5, 1e-6 * scale)
        else:
            ref = reference_select(csr, data, sample, method)
            ref_err = compare(torch.from_numpy(out_np[:, sample]), torch.from_numpy(ref), False, 1e-5, 1e-6 * scale)
        checksum = float(np.nansum(out_np))
        print(
            f"  {cls.__name__}({method}): weights {build_s:.3f} s, nnz {csr.nnz}, "
            f"w_max {regridder._padded.w_max}; regrid {apply_s:.4f} s (first call) via {name} "
            f"(launches +{rose[name]}); vs plain max |diff| {err:.3e}; vs host reference "
            f"max |diff| {ref_err:.3e}; finite {finite:.6f}; checksum {checksum!r}"
        )
    return counts, max_err, results, ((verts, faces), (tverts, tfaces), data)


def cuda_time_ms(fn, reps=10, warmup=2, inner=10):
    """Median milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``inner`` calls back to back, so the host's launch
    work overlaps the device's; ``inner`` 1 times one call from an idle
    card, the host's launch work included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def card_ms(fn):
    """CUDA event milliseconds of one call after a warm-up (median of 3)."""
    return cuda_time_ms(fn, reps=3, warmup=1, inner=1)


@contextlib.contextmanager
def warnings_ignored():
    """A block in which numpy's RuntimeWarnings (empty or all-NaN slices)
    are not shown."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def bound_ms(true_bytes, operations, dtype_name, copy_gbps):
    """The least time the card could take: the larger of the bytes over
    this run's copy rate and the operations over the peak rate of their
    type.  Returns (ms, "bytes" or "operations")."""
    by_bytes = true_bytes / (copy_gbps * 1e9) * 1e3
    by_ops = operations / PEAK_FLOPS[dtype_name] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_timing(device, results, card, title="phase 4"):
    """Phase 4: kernel, plain and apply-pass times at the 1M config,
    each pass one launch on the (E, m) source.  ``results`` holds
    (class, label, kernel, regridder, ...) per regridder; the times are
    keyed by (label, E).  The yardstick
    ``library_ms``: for the sum-kind methods ``torch.sparse.mm`` of the
    weight matrix with the staged (m, E) copy, which computes the same
    sums; for the median ``torch.nanquantile`` over the pre-gathered
    (n, E, w) windows with pads as NaN, which leaves out the gather and
    the weight gate; none for the mode."""
    import torch

    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import reduce_lanes, window_reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights
    from xugrid_tpu_torch.regrid.select_apply import register_slots

    buf = torch.empty(1 << 28, dtype=torch.float32, device=device)
    dst = torch.empty_like(buf)
    copy_ms = cuda_time_ms(lambda: dst.copy_(buf))
    copy_gbps = 2 * buf.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del buf, dst
    print(f"{title} [{card}]: device copy {copy_gbps:.1f} GB/s (1 GiB copy_, {copy_ms:.4f} ms)")
    rng = np.random.default_rng(0)
    timed = {}
    for cls, method, kernel, regridder, *_ in results:
        csr = regridder._weights
        n, m = csr.n, csr.m
        idx, w = device_weights(regridder._padded, torch.float32, device, regridder._device_weights)
        red = regridder._reduction
        w_max = idx.shape[1]
        lengths = np.diff(csr.indptr).astype(np.int64)
        library = None
        if kernel is window_reduce:
            library = torch.sparse_csr_tensor(
                *(torch.from_numpy(a.astype(np.int32)).to(device) for a in (csr.indptr, csr.indices)),
                torch.from_numpy(csr.data.astype(np.float32)).to(device), size=(n, m),
            )
        for n_extra in TIMING_EXTRAS:
            source = torch.from_numpy(rng.normal(size=(n_extra, m)).astype(np.float32)).to(device)
            run_kernel = lambda: kernel(source, idx, w, red)  # noqa: E731
            run_plain = lambda: reduce.reduce_windows(source.t(), idx, w, red).t()  # noqa: E731
            if kernel is window_reduce:
                lanes = f", (slice warps, target warps, staged) {reduce_lanes(n_extra, w_max, 4)}"
                operations = 2 * csr.nnz * n_extra
            else:
                lanes = (
                    f", K={register_slots(w_max)}, (slice warps, target warps, staged) "
                    f"{reduce_lanes(n_extra, w_max, 4, batch=1)}, pair steps "
                    f"{int((lengths ** 2).sum()) * n_extra}"
                )
                operations = csr.nnz * n_extra * int(np.ceil(np.log2(max(w_max, 2))))
            true_bytes = csr.nnz * 8 + m * n_extra * 4 + n * n_extra * 4
            samples = {"kernel": [], "plain": []}
            # Interleave plain, kernel, kernel, plain.
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = run_kernel if which == "kernel" else run_plain
                samples[which].append(cuda_time_ms(fn, reps=5))
            kernel_ms = statistics.median(samples["kernel"])
            plain_ms = statistics.median(samples["plain"])
            run_apply = lambda: apply_weights(regridder._padded, source, red, n, plan_cache=regridder._device_weights)  # noqa: E731
            rows = [
                ("kernel", kernel_ms), ("kernel, one launch from idle", cuda_time_ms(run_kernel, inner=1)),
                ("plain", plain_ms), ("apply pass", cuda_time_ms(run_apply)),
                ("apply pass, one call from idle", cuda_time_ms(run_apply, inner=1)),
            ]
            library_ms = None
            if library is not None:
                sourceT = source.t().contiguous()
                library_ms = cuda_time_ms(lambda: torch.sparse.mm(library, sourceT))
                rows.append(("torch.sparse.mm", library_ms))
                del sourceT
            elif red is not reduce.mode:
                gathered = reduce.gather_windows(source.t(), idx)
                library_ms = cuda_time_ms(lambda: torch.nanquantile(gathered, red.p / 100.0, dim=-1), reps=5)
                rows.append(("torch.nanquantile, windows gathered", library_ms))
                del gathered
            bound, bound_by = bound_ms(true_bytes, operations, "float32", copy_gbps)
            print(
                f"  {method} E={n_extra} bound ({kernel.__name__}): {bound:.6f} ms by {bound_by} "
                f"({operations} operations), kernel at {100 * bound / kernel_ms:.2f} % of it{lanes} [{card}]"
            )
            # The apply pass is one launch of the kernel: every device
            # activity the profiler records (it may drop a few) is one of
            # its launches, with no transpose or copy beside them.
            calls = 10
            prof = profiled_us(run_apply, kernel.__name__, calls=calls)
            if prof is None:
                print(f"  {method} E={n_extra} apply pass profile: no device time recorded, not measured")
            else:
                print(
                    f"  {method} E={n_extra} apply pass profile: {prof[3]:g} device activities per call, "
                    f"{prof[1]} {kernel.__name__} launches in {calls} calls, {prof[0]:.3f} us per launch [{card}]"
                )
                if round(prof[3] * calls) != prof[1] or prof[1] > calls:
                    raise AssertionError(
                        f"{method} E={n_extra}: the apply pass ran device activities besides {kernel.__name__}"
                    )
            for label, ms in rows:
                gbps = true_bytes / (ms * 1e-3) / 1e9
                print(
                    f"  {method} E={n_extra} {label} ({kernel.__name__}): {ms * 1e-3:.6f} s/pass, "
                    f"true bytes {true_bytes}, {gbps:.1f} GB/s, {100 * gbps / copy_gbps:.2f} % of copy "
                    f"[{card}]"
                )
            timed[(method, n_extra)] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": bound_by,
            }
            del source
            torch.cuda.empty_cache()
    return timed, copy_gbps


def unknown_residuals(W, values, filled):
    """Independent host check of a fill: per column, the norm of the
    residual of the unknown system (D - W)_uu x_u - W_uk x_k, in float64
    with scipy.  ``values`` (E, n) holds NaN at the unknowns."""
    import scipy.sparse

    unknown = np.isnan(values[0])
    W = W.tocsr()
    L = scipy.sparse.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    L_uu = L[unknown][:, unknown]
    W_uk = W[unknown][:, ~unknown]
    r = L_uu @ filled[:, unknown].T - W_uk @ values[:, ~unknown].T
    return np.linalg.norm(r, axis=0)


def host_stages(info):
    """The host stages of a solve, from ``last_solve_info``."""
    return ", ".join(f"{k} {info[k]:.4f}" for k in ("hash_s", "prep_s", "rhs_s", "scatter_s"))


def laplace_run(label, W, labels, data, degree, truth):
    """One laplace_interpolate call through the entry point, checked:
    csr_matvec launches, shape, finiteness and the host residual.
    Returns (filled, info, launches)."""
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec
    from xugrid_tpu_torch.ugrid import interpolate

    before = csr_matvec.launches
    t0 = time.perf_counter()
    filled = interpolate.laplace_interpolate(
        data, W, components_labels=labels, precondition_degree=degree, **LAPLACE_SOLVE
    )
    wall = time.perf_counter() - t0
    info = dict(interpolate.last_solve_info)
    launches = csr_matvec.launches - before
    expected = 1 + (degree - 1) + info["iterations"] * degree
    if launches != expected:
        raise AssertionError(
            f"{label}: csr_matvec launches {launches} "
            f"(expected {expected} for {info['iterations']} iterations at degree {degree})"
        )
    if filled.shape != data.shape or not np.isfinite(filled).all():
        raise AssertionError(f"{label}: output {filled.shape}, finite {np.isfinite(filled).mean()}")
    residual = unknown_residuals(W, np.atleast_2d(data), np.atleast_2d(filled))
    if residual.max() > 10 * LAPLACE_SOLVE["atol"]:
        raise AssertionError(f"{label}: host residual {residual.max():.3e} > 10 * atol")
    # Each slice is a multiple of the truth field: compare with it.
    data2 = np.atleast_2d(data)
    k0 = np.flatnonzero(~np.isnan(data2[0]))[0]
    scales = data2[:, k0] / truth[k0]
    err = float(np.abs(np.atleast_2d(filled) - scales[:, None] * truth[None, :]).max())
    print(
        f"  {label}: {info['iterations']} iterations, csr_matvec launches "
        f"+{launches}, host residual max {residual.max():.3e}, max |fill - truth| {err:.4f}, "
        f"wall {wall:.3f} s (host {info['host_s']:.3f} s: {host_stages(info)}; device "
        f"{info['device_s']:.3f} s), {info['n_unknown'] * data2.shape[0] / wall:.1f} unknown values/s"
    )
    return filled, info, launches


def phase_laplace(device):
    """Phase 5: the Laplace fill at the scale demo's 1M configuration,
    through the entry point, on the card."""
    from scipy.sparse.csgraph import connected_components

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.ugrid import interpolate

    kernels = (window_reduce, window_select, csr_matvec)
    meshes = {}
    t0 = time.perf_counter()
    nodes, faces = delaunay_mesh(LAPLACE_SIDE)
    t1 = time.perf_counter()
    grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    W = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=False).astype(np.float64)
    W.data = np.ones_like(W.data)
    _, labels = connected_components(W)
    t2 = time.perf_counter()
    truth, values = laplace_inputs(nodes)
    print(
        f"phase 5: Delaunay mesh {len(nodes)} nodes, {len(faces)} faces in {t1 - t0:.3f} s; "
        f"node connectivity nnz {W.nnz} and components in {t2 - t1:.3f} s; "
        f"{int(np.isnan(values).sum())} unknowns"
    )
    meshes["delaunay"] = (W, labels, values, truth)
    meshes["delaunay_grid"] = grid
    t0 = time.perf_counter()
    snodes, sfaces = structured_triangle_mesh(LAPLACE_SIDE)
    sgrid = xt.Ugrid2d(snodes[:, 0], snodes[:, 1], -1, sfaces)
    SW = sgrid.get_connectivity_matrix(sgrid.node_dimension, xy_weights=False).astype(np.float64)
    SW.data = np.ones_like(SW.data)
    _, slabels = connected_components(SW)
    struth, svalues = laplace_inputs(snodes)
    print(f"  structured mesh {len(snodes)} nodes, {len(sfaces)} faces, connectivity in {time.perf_counter() - t0:.3f} s")
    meshes["structured"] = (SW, slabels, svalues, struth)
    stack = np.where(
        np.isnan(values)[None, :], np.nan,
        truth[None, :] * (1.0 + 0.05 * np.arange(LAPLACE_SLICES))[:, None],
    )
    for k in kernels:
        k.launches = 0
    runs = {}
    for label, data, degree in (("degree 1", values, 1), ("degree 4", values, 4),
                                (f"{LAPLACE_SLICES} slices, degree 4", stack, 4)):
        runs[label] = laplace_run(label, W, labels, data, degree, truth)
    # The Delaunay CG system as laplace_interpolate prepared it on the
    # card, for phase 6.
    (meshes["delaunay_prep"],) = (v for k, v in interpolate._SYSTEMS.items() if k[0] == "laplace")
    runs["structured, degree 4"] = laplace_run("structured, degree 4", SW, slabels, svalues, 4, struth)
    counts = {k.__name__: k.launches for k in kernels}
    if counts["window_reduce"] or counts["window_select"] or not counts["csr_matvec"]:
        raise AssertionError(f"Laplace fill launched {counts}")
    return counts, runs, meshes


def cold_time_ms(fn, flush, reps=10):
    """Median milliseconds of one ``fn`` launched right after ``flush``
    is overwritten (a buffer larger than the 50 MB L2), so its inputs
    come from device memory."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_laplace_timing(device, card, copy_gbps, meshes):
    """Phase 6: csr_matvec on the 1M Delaunay CG system beside its plain
    version, torch.sparse.mm and its bound, warm and with a cold L2;
    repeat solves; a profile."""
    import torch

    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain
    from xugrid_tpu_torch.ugrid import interpolate

    W, labels, values, truth = meshes["delaunay"]
    # The CG system of the Delaunay fill, as laplace_interpolate cached
    # it on the card (compacted to the unknowns, RCM-relabelled).
    prep = meshes["delaunay_prep"]
    indptr, indices, data64 = (prep["system"][k] for k in ("indptr", "indices", "data"))
    n, nnz = indptr.numel() - 1, data64.numel()
    print(f"phase 6 [{card}]: CG system n {n}, nnz {nnz}, widest row {int((indptr[1:] - indptr[:-1]).max())}")
    rng = np.random.default_rng(1)
    flush = torch.empty(1 << 26, dtype=torch.float32, device=device)  # 256 MB
    timed = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        data = data64.to(dtype)
        size = data.element_size()
        # The library yardstick (torch.sparse.mm); the port never calls it.
        library = torch.sparse_csr_tensor(indptr, indices, data, size=(n, n))
        for E in (1, LAPLACE_SLICES):
            x = torch.from_numpy(rng.normal(size=(n, E))).to(device=device, dtype=dtype)
            samples = {"kernel": [], "plain": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                if which == "kernel":
                    samples[which].append(cuda_time_ms(lambda: csr_matvec(indptr, indices, data, x), reps=20))
                else:
                    samples[which].append(
                        cuda_time_ms(lambda: csr_matvec_plain(indptr, indices, data, x), reps=3, inner=2)
                    )
            kernel_ms = statistics.median(samples["kernel"])
            plain_ms = statistics.median(samples["plain"])
            single_ms = cuda_time_ms(lambda: csr_matvec(indptr, indices, data, x), reps=20, inner=1)
            library_ms = cuda_time_ms(lambda: torch.sparse.mm(library, x), reps=20)
            kernel_cold = cold_time_ms(lambda: csr_matvec(indptr, indices, data, x), flush)
            library_cold = cold_time_ms(lambda: torch.sparse.mm(library, x), flush)
            got = csr_matvec(indptr, indices, data, x)
            err = compare(got, csr_matvec_plain(indptr, indices, data, x), True, 0.0, 0.0)
            true_bytes = nnz * (4 + size) + (n + 1) * 4 + 2 * n * E * size
            bound, bound_by = bound_ms(true_bytes, 2 * nnz * E, name, copy_gbps)
            print(
                f"  csr_matvec {name} E={E}: kernel {kernel_ms:.6f} ms (one launch from "
                f"idle {single_ms:.6f}, cold L2 {kernel_cold:.6f}), plain {plain_ms:.6f} ms, torch.sparse.mm "
                f"{library_ms:.6f} ms (cold L2 {library_cold:.6f}); true bytes {true_bytes}, bound "
                f"{bound:.6f} ms by {bound_by} (copy {copy_gbps:.1f} GB/s), kernel at "
                f"{100 * bound / kernel_ms:.2f} % of the bound warm, {100 * bound / kernel_cold:.2f} % "
                f"cold, {true_bytes / (kernel_ms * 1e-3) / 1e9:.1f} GB/s; bit-equal to plain [{card}]"
            )
            timed[(name, E)] = {
                "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
            }
            del x
    del flush
    stack = np.where(
        np.isnan(values)[None, :], np.nan,
        truth[None, :] * (1.0 + 0.05 * np.arange(LAPLACE_SLICES))[:, None],
    )
    for label, data, degree, mesh in (
        ("degree 1", values, 1, "delaunay"), ("degree 4", values, 4, "delaunay"),
        (f"{LAPLACE_SLICES} slices, degree 4", stack, 4, "delaunay"),
        ("structured, degree 4", None, 4, "structured"),
    ):
        Wm, lm, vm, _ = meshes[mesh]
        data = vm if data is None else data
        infos = []
        for _ in range(3):
            t0 = time.perf_counter()
            interpolate.laplace_interpolate(data, Wm, components_labels=lm, precondition_degree=degree, **LAPLACE_SOLVE)
            infos.append(dict(interpolate.last_solve_info, wall=time.perf_counter() - t0))
        info = {k: statistics.median(i[k] for i in infos) for k in infos[0] if k.endswith("_s") or k == "wall"}
        wall, dev, iterations = info["wall"], info["device_s"], infos[-1]["iterations"]
        print(
            f"  solve {label} ({iterations} iterations), median of 3 warm: wall {wall:.4f} s, device "
            f"{dev:.4f} s, host {info['host_s']:.4f} s ({host_stages(info)}), "
            f"{infos[-1]['n_unknown'] / wall:.1f} nodes/s, {1e3 * dev / max(iterations, 1):.4f} ms per "
            f"iteration [{card}]"
        )
    profile_solve(values, W, labels, card)
    return timed


def profile_solve(values, W, labels, card):
    """torch.profiler over one warm degree-4 solve: device time by kernel
    (the profiler's table, printed), the device's busy share
    of the wall time, csr_matvec's share of the busy time, the count of
    device activities, and the host's own time in the operators that
    issued them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xugrid_tpu_torch.ugrid import interpolate

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        interpolate.laplace_interpolate(values, W, components_labels=labels, precondition_degree=4, **LAPLACE_SOLVE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Kernels, copies and memsets are device events; an operator (CPU
    # event) also reports its kernels' time, so only device events count.
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    if busy_us == 0:
        print(f"  profile: the profiler recorded no device time; busy share not measured [{card}]")
        return
    host_us = sum(e.self_cpu_time_total for e in events if e.device_type == DeviceType.CPU)
    matvec_us = sum(e.self_device_time_total for e in on_device if "csr_matvec" in e.key)
    iterations = interpolate.last_solve_info["iterations"]
    print(events.table(sort_by="self_cuda_time_total", row_limit=15))
    top = sorted(on_device, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    print(
        f"  profile of a warm degree-4 solve ({iterations} iterations): wall {wall:.4f} s (profiler on), "
        f"device busy {busy_us * 1e-6:.4f} s = {100 * busy_us * 1e-6 / wall:.2f} % of the wall, "
        f"{busy_us * 1e-3 / iterations:.4f} ms per iteration, csr_matvec {100 * matvec_us / busy_us:.2f} % "
        f"of it; {sum(e.count for e in on_device)} device activities; host self time in operators "
        f"{host_us * 1e-6:.4f} s; top: " + "; ".join(
            f"{e.key[:48]} {e.self_device_time_total * 1e-3:.3f} ms x{e.count}" for e in top
        ) + f" [{card}]"
    )


def host_us(fn, calls=50, reps=5):
    """Host microseconds per call of ``fn``: the host's clock around
    ``calls`` calls issued back to back, read before waiting for the
    card (median of ``reps``), so it counts the host's work per call
    (checks, allocation, launch) and not the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def profiled_us(fn, kernel, calls=20):
    """torch.profiler over ``calls`` calls of ``fn``: (device us per
    launch of the kernels whose name holds ``kernel``, their launches,
    device busy us per call, device activities per call), or None when
    the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device)
    ours = [e for e in on_device if kernel in e.key]
    launches = sum(e.count for e in ours)
    if busy == 0 or launches == 0:
        return None
    activities = sum(e.count for e in on_device)
    return sum(e.self_device_time_total for e in ours) / launches, launches, busy / calls, activities / calls


def time_line(label, what, fn, kernel, card):
    """Print ``what``'s times by every method (back to back, one call
    from idle, host us per call, the profiler's device us per launch of
    ``kernel``), tagged ``label``."""
    b2b = cuda_time_ms(fn)
    idle = cuda_time_ms(fn, inner=1)
    host = host_us(fn)
    prof = profiled_us(fn, kernel)
    device = (
        f"{kernel} device {prof[0]:.3f} us/launch ({prof[1]} launches), device busy {prof[2]:.3f} us/call, "
        f"{prof[3]:g} device activities/call"
        if prof else "device time not measured (the profiler recorded none)"
    )
    print(
        f"  compare[{label}] {what}: back to back {b2b:.6f} ms, one call from idle {idle:.6f} ms, "
        f"host {host:.3f} us/call; {device} [{card}]"
    )


def phase_compare(device, card, label):
    """``--compare``: the apply pass of the 1M regrid (mean,
    first_order_conservative, median and mode, float32, E = 1, 20, 128;
    the selections held bit for bit) and csr_matvec on
    the 1M Delaunay CG system (float64 and float32, E = 1 and 20), each
    checked against its plain version and timed by ``time_line``.  Uses
    only what every version of the port has: the regridders,
    ``apply_weights``, ``device_weights``, ``reduce_windows``,
    ``csr_matvec`` and its plain version, ``laplace_interpolate``."""
    import torch
    from scipy.sparse.csgraph import connected_components

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain
    from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights
    from xugrid_tpu_torch.ugrid import interpolate

    rng = np.random.default_rng(42)
    (verts, faces), (tverts, tfaces) = bench_meshes(N_SIDE, T_SIDE, rng)
    source_grid = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target_grid = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    for cls, method, kernel in (
        (xt.OverlapRegridder, "mean", "window_reduce"),
        (xt.RelativeOverlapRegridder, "first_order_conservative", "window_reduce"),
        (xt.OverlapRegridder, "median", "window_select"),
        (xt.OverlapRegridder, "mode", "window_select"),
    ):
        regridder = cls(source_grid, target_grid, method=method)
        padded, cache, red = regridder._padded, regridder._device_weights, regridder._reduction
        n = target_grid.n_face
        for E in TIMING_EXTRAS:
            data = rng.normal(size=(E, source_grid.n_face))
            if method == "mode":
                data = np.round(data * 2.0) / 2.0  # windows hold equal values
            source = torch.from_numpy(data.astype(np.float32)).to(device)
            run = lambda: apply_weights(padded, source, red, n, plan_cache=cache)  # noqa: E731
            idx, w = device_weights(padded, torch.float32, device, cache)
            want = reduce.reduce_windows(source.t().contiguous(), idx, w, red).t()
            if kernel == "window_select":
                compare(run(), want, True, 0.0, 0.0)
            else:
                rtol, atol = tolerance(torch.float32, float(source.abs().max()))
                compare(run(), want, False, rtol, torch.clamp(summation_bound(source, idx, w, red), min=atol))
            time_line(label, f"apply pass {method} E={E}", run, kernel, card)
            del source, want
    nodes, faces = delaunay_mesh(LAPLACE_SIDE)
    grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    W = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=False).astype(np.float64)
    W.data = np.ones_like(W.data)
    _, labels = connected_components(W)
    _, values = laplace_inputs(nodes)
    interpolate.laplace_interpolate(values, W, components_labels=labels, precondition_degree=4, **LAPLACE_SOLVE)
    (prep,) = (v for k, v in interpolate._SYSTEMS.items() if k[0] == "laplace")
    indptr, indices, data64 = (prep["system"][k] for k in ("indptr", "indices", "data"))
    n = indptr.numel() - 1
    for dtype in (torch.float64, torch.float32):
        data = data64.to(dtype)
        for E in (1, LAPLACE_SLICES):
            x = torch.from_numpy(rng.normal(size=(n, E))).to(device=device, dtype=dtype)
            run = lambda: csr_matvec(indptr, indices, data, x)  # noqa: E731
            compare(run(), csr_matvec_plain(indptr, indices, data, x), True, 0.0, 0.0)
            time_line(label, f"csr_matvec {str(dtype)[6:]} E={E}", run, "csr_matvec", card)


#: Phase 7's network: random-walk polylines x segments, on the 1M mesh.
NETWORK_LINES, NETWORK_SEGMENTS = 100, 1000


def sorted_triplets(csr):
    """(target, source, weight) of a CSR weight matrix, sorted by (target,
    source)."""
    rows = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    order = np.lexsort((csr.indices, rows))
    return rows[order], csr.indices[order], csr.data[order]


def build_stages(label, build_s):
    """Print the host stages of the weight build just done
    (``timings.summary()``, reset before the build)."""
    from xugrid_tpu_torch.utils.profiling import timings

    stages = "; ".join(
        f"{name} {rec['total_s']:.3f} s x{rec['count']}" for name, rec in timings.summary().items()
    )
    print(f"  {label} weight build {build_s:.3f} s; host stages: {stages}")


def check_apply(label, regridder, source, out, kernel, rose, scale, reference):
    """An apply of ``regridder`` on the (E, m) ``source``: only ``kernel``
    launched, the output against the plain version on the card
    (``window_select`` bit for bit) and against ``reference`` (host) at
    float32 tolerances.  Returns the largest |kernel - plain|."""
    import torch

    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
    from xugrid_tpu_torch.regrid.apply import device_weights

    name = kernel.__name__
    if rose[name] != 1 or sum(rose.values()) != 1:
        raise AssertionError(f"{label}: expected one launch of {name}, counters rose by {rose}")
    idx, w = device_weights(regridder._padded, source.dtype, source.device, regridder._device_weights)
    plain = reduce.reduce_windows(source.t().contiguous(), idx, w, regridder._reduction).t()
    rtol, atol = tolerance(source.dtype, scale)
    bound = atol
    if kernel is window_reduce:
        bound = torch.clamp(summation_bound(source, idx, w, regridder._reduction), min=atol)
    err = compare(out, plain, kernel is not window_reduce, rtol, bound)
    got, want = reference(out.double().cpu().numpy())
    ref_err = compare(torch.from_numpy(got), torch.from_numpy(want), False, 1e-5, 1e-6 * scale)
    finite = float(torch.isfinite(out).double().mean())
    print(
        f"  {label}: {name} +1 launch; vs plain max |diff| {err:.3e}; vs host reference max |diff| "
        f"{ref_err:.3e}; finite {finite:.6f}; nnz {regridder._weights.nnz}, w_max {regridder._padded.w_max}"
    )
    return err


def phase_regridders(device, card, inputs):
    """Phase 7: CentroidLocatorRegridder (mesh -> raster),
    BarycentricInterpolator (both directions) and NetworkGridder (mean,
    mode) at the 1M config, through their entry points on the card, with
    the launch counters, checks and times described in the module
    docstring.  Returns (launch counts, largest |kernel - plain| per
    kernel, apply times keyed by (label, E))."""
    import torch
    from scipy.sparse import csr_matrix

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.utils.profiling import timings

    (verts, faces), (tverts, tfaces), mesh_data = inputs
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    raster = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    rng = np.random.default_rng(17)
    raster_data = rng.normal(size=(N_EXTRA, raster.n_face)).astype(np.float32)
    raster_data[rng.random(raster_data.shape) < 0.01] = np.nan
    data = {"mesh": mesh_data, "raster": raster_data}
    grids = {"mesh": mesh, "raster": raster}
    cell = {"mesh": 1.0, "raster": N_SIDE / T_SIDE}
    print(f"phase 7: meshes {mesh.n_face} and {raster.n_face} faces, {N_EXTRA} float32 slices with 1 % NaN")
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    timing_runs = []

    def run(regridder, source):
        before = {k.__name__: k.launches for k in kernels}
        t0 = time.perf_counter()
        out = regridder.regrid(source)
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches - before[k.__name__] for k in kernels}, time.perf_counter() - t0

    # CentroidLocatorRegridder: a row gather, no kernel.
    timings.reset()
    t0 = time.perf_counter()
    centroid = xt.CentroidLocatorRegridder(mesh, raster)
    build_stages("CentroidLocatorRegridder mesh -> raster", time.perf_counter() - t0)
    source = torch.from_numpy(mesh_data).to(device)
    out, rose, apply_s = run(centroid, source)
    if any(rose.values()):
        raise AssertionError(f"CentroidLocatorRegridder launched kernels: {rose}")
    w = centroid._weights
    want = np.full((N_EXTRA, raster.n_face), np.nan, dtype=np.float32)
    want[:, w.row] = mesh_data[:, w.col]
    compare(out, torch.from_numpy(want), True, 0.0, 0.0)
    gather_ms = cuda_time_ms(lambda: centroid.regrid(source))
    gather_bytes = 4 * N_EXTRA * (w.nnz + raster.n_face) + 16 * w.nnz
    print(
        f"  CentroidLocatorRegridder: {w.nnz} of {raster.n_face} targets located; no launch; bit-equal to "
        f"numpy out[:, row] = data[:, col]; apply {apply_s:.4f} s (first call), {gather_ms:.6f} ms back to "
        f"back, true bytes {gather_bytes} [{card}]"
    )

    # BarycentricInterpolator, both directions.
    for src, tgt in (("mesh", "raster"), ("raster", "mesh")):
        label = f"BarycentricInterpolator {src} -> {tgt}"
        timings.reset()
        t0 = time.perf_counter()
        regridder = xt.BarycentricInterpolator(grids[src], grids[tgt])
        build_stages(f"{label} (angle sort on the card)", time.perf_counter() - t0)
        timings.reset()
        t0 = time.perf_counter()
        on_host = xt.BarycentricInterpolator(grids[src], grids[tgt], device="cpu")
        build_stages(f"{label} (angle sort on the host)", time.perf_counter() - t0)
        (r1, c1, w1), (r2, c2, w2) = sorted_triplets(regridder._weights), sorted_triplets(on_host._weights)
        if not (np.array_equal(r1, r2) and np.array_equal(c1, c2)):
            raise AssertionError(f"{label}: card- and host-sorted weights differ in their indices")
        weight_diff = float(np.max(np.abs(w1 - w2) / np.abs(w2))) if len(w2) else 0.0
        if weight_diff > 1e-12:
            raise AssertionError(f"{label}: card- and host-sorted weights differ by rtol {weight_diff:.3e}")
        csr = regridder._weights
        rows = np.diff(csr.indptr) > 0
        sums = np.add.reduceat(csr.data, csr.indptr[:-1][rows]) if rows.any() else np.zeros(0)
        row_err = float(np.abs(sums - 1.0).max())
        if row_err > 1e-12:
            raise AssertionError(f"{label}: a weight row sums to 1 + {row_err:.3e}")
        print(
            f"  {label}: weights nnz {csr.nnz}, w_max {regridder._padded.w_max}, {int(rows.sum())} of {csr.n} "
            f"targets weighted; card- and host-sorted triplets equal (weights within rtol {weight_diff:.3e}); "
            f"rows sum to 1 within {row_err:.3e}"
        )
        source = torch.from_numpy(data[src]).to(device)
        out, rose, apply_s = run(regridder, source)
        W = csr_matrix((csr.data, csr.indices, csr.indptr), shape=(csr.n, csr.m))
        err = check_apply(
            label, regridder, source, out, window_reduce, rose, float(np.nanmax(np.abs(data[src]))),
            lambda got, csr=csr: (got, reference_linear(csr, data[src], relative=False)),
        )
        max_err["window_reduce"] = max(max_err["window_reduce"], err)
        # A linear field comes back exact at targets two source cells
        # inside the boundary.
        field = lambda c: 2.0 * c[:, 0] + 3.0 * c[:, 1] + 1.0  # noqa: E731
        linear = torch.from_numpy(field(grids[src].centroids)[None, :]).to(device)
        got = regridder.regrid(linear)[0].cpu().numpy()
        c = grids[tgt].centroids
        margin = 2.0 * cell[src]
        inner = ((c > margin) & (c < N_SIDE - margin)).all(axis=1)
        rel = np.abs(got[inner] - field(c)[inner]) / np.abs(field(c)[inner])
        if not np.isfinite(rel).all() or rel.max() > 1e-9:
            raise AssertionError(f"{label}: linear field off by rtol {np.nanmax(rel):.3e}")
        print(f"  {label}: linear field 2x + 3y + 1 exact within rtol {rel.max():.3e} at {int(inner.sum())} inner targets")
        timing_runs.append((xt.BarycentricInterpolator, f"barycentric {src}->{tgt}", window_reduce, regridder))

    # NetworkGridder: random-walk polylines onto the 1M mesh.
    t0 = time.perf_counter()
    nodes, edges = random_network(NETWORK_LINES, NETWORK_SEGMENTS, float(N_SIDE), rng)
    network = xt.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
    values = (np.round(rng.normal(size=(N_EXTRA, network.n_edge)) * 2.0) / 2.0).astype(np.float32)
    values[rng.random(values.shape) < 0.01] = np.nan
    source = torch.from_numpy(values).to(device)
    print(
        f"  network: {network.n_edge} edges in {NETWORK_LINES} polylines, length {network.edge_length.sum():.1f}, "
        f"made in {time.perf_counter() - t0:.3f} s"
    )
    for method, kernel in (("mean", window_reduce), ("mode", window_select)):
        label = f"NetworkGridder({method})"
        timings.reset()
        t0 = time.perf_counter()
        gridder = xt.NetworkGridder(network, mesh, method=method)
        build_stages(label, time.perf_counter() - t0)
        out, rose, apply_s = run(gridder, source)
        csr = gridder._weights
        if method == "mean":
            reference = lambda got, csr=csr: (got, reference_linear(csr, values, relative=False))  # noqa: E731
        else:
            weighted = np.flatnonzero(np.diff(csr.indptr) > 0)
            sample = np.sort(rng.choice(weighted, size=min(400, len(weighted)), replace=False))
            reference = lambda got, csr=csr, sample=sample: (  # noqa: E731
                got[:, sample], reference_select(csr, values, sample, "mode")
            )
        err = check_apply(label, gridder, source, out, kernel, rose, float(np.nanmax(np.abs(values))), reference)
        max_err[kernel.__name__] = max(max_err[kernel.__name__], err)
        timing_runs.append((xt.NetworkGridder, f"network {method}", kernel, gridder))
    counts = {k.__name__: k.launches for k in kernels}
    if counts["csr_matvec"] or not counts["window_reduce"] or not counts["window_select"]:
        raise AssertionError(f"phase 7 launched {counts}")
    timed, _ = phase_timing(device, timing_runs, card, title="phase 7 apply times")
    return counts, max_err, timed


#: Phase 8's raster source: RASTER_SIDE^2 cells over phase 3's extent.
RASTER_SIDE = 1000


def raster_dataarray(side, data, descending=True, extent=None):
    """A side x side raster DataArray over [0, extent]^2 (default N_SIDE),
    (y, x) or (time, y, x) by ``data``'s rank, with ``dx``/``dy`` and ``y``
    descending (north up) unless ``descending`` is False."""
    import xugrid_tpu_torch as xt

    cell = (N_SIDE if extent is None else extent) / side
    x = (np.arange(side) + 0.5) * cell
    coords = {"y": x[::-1].copy() if descending else x, "x": x, "dx": cell, "dy": -cell if descending else cell}
    dims = ("y", "x")
    if data.ndim == 3:
        coords["time"] = np.arange(data.shape[0])
        dims = ("time",) + dims
    return xt.xdata.DataArray(data, coords=coords, dims=dims, name="v", attrs={"units": "m"})


def check_labelled(label, out, target, n_extra, device):
    """A regrid result onto the raster ``target``: a DataArray (time, y,
    x) whose payload is a tensor on ``device`` (the card), with the
    raster's y, x, dy and dx coordinates and the source's time."""
    import torch

    import xugrid_tpu_torch as xt

    if not isinstance(out, xt.xdata.DataArray) or out.dims != ("time", "y", "x"):
        raise AssertionError(f"{label}: {type(out).__name__} {getattr(out, 'dims', None)}")
    if not isinstance(out.data, torch.Tensor) or out.data.device != device:
        raise AssertionError(f"{label}: the payload is not a tensor on {device}: {type(out.data).__name__}")
    if out.shape != (n_extra,) + target.shape:
        raise AssertionError(f"{label}: shape {out.shape}")
    np.testing.assert_array_equal(out["time"].values, np.arange(n_extra))
    for name in ("y", "x"):
        np.testing.assert_array_equal(out[name].values, target[name].values)
    for name, dim in (("dy", "y"), ("dx", "x")):
        if out._coords[name].dims != (dim,) or not np.allclose(out[name].values, abs(float(target[name].values))):
            raise AssertionError(f"{label}: coordinate {name} {out._coords[name].dims}")


def overcap_mesh(n_side=40):
    """Regular 40- and 120-node polygons (faces 0-3) laid over n_side^2
    unit quads, padded with -1: points in a polygon locate to it, the
    lowest face holding them.  Faces of 40 nodes are the ones the native
    padded clip and mean-value kernel still take once the buffer is cut
    to their width.  Returns (nodes, faces, nodes per face)."""
    verts, quads = quad_mesh(n_side, n_side)
    polygons = [(40, (6.0, 6.0), 3.0), (40, (20.0, 9.0), 2.0), (120, (30.0, 30.0), 6.0), (120, (12.0, 28.0), 4.5)]
    nodes, faces = [verts], []
    offset = len(verts)
    for n, (cx, cy), r in polygons:
        angle = 0.1 + 2.0 * np.pi * np.arange(n) / n
        nodes.append(np.column_stack([cx + r * np.cos(angle), cy + r * np.sin(angle)]))
        faces.append(np.pad(offset + np.arange(n), (0, 120 - n), constant_values=-1)[None, :])
        offset += n
    faces = np.concatenate(faces + [np.pad(quads, ((0, 0), (0, 116)), constant_values=-1)])
    return np.concatenate(nodes), faces, (faces >= 0).sum(axis=1)


def phase_overcap(device, card):
    """Phase 8.4: the exact geometry of faces above the native kernels'
    sizes on the card: overlap areas and mean-value weights against the
    native host kernels where those take the face (40 nodes, buffer cut
    to 40 columns), and against the same torch geometry on the CPU for
    120-node faces; the OverlapRegridder entry point on the card, each
    face's areas summing to its own area."""
    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.spatial import celltree, geometry
    from xugrid_tpu_torch.spatial.bvh import face_bounding_boxes
    from xugrid_tpu_torch.utils import native

    nodes, faces, n_nodes = overcap_mesh()
    mesh = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, faces)
    tverts, tfaces = quad_mesh(30, 30, dx=40.0 / 30)
    raster = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    boxes = face_bounding_boxes(tfaces, tverts[:, 0], tverts[:, 1])
    qi, ti = mesh.celltree.grid_hash.query_boxes(boxes)
    query_xy = geometry.pad_polygons(tfaces, tverts[:, 0], tverts[:, 1])
    tree_xy = mesh.celltree._poly_xy_host
    big = n_nodes[ti] > 40
    t0 = time.perf_counter()
    on_card = celltree.overlap_areas_device(qi, ti, query_xy, tree_xy, device)
    card_s = time.perf_counter() - t0
    host = native.polygon_clip_areas_native(qi[~big], ti[~big], query_xy, np.ascontiguousarray(tree_xy[:, :40]))
    cut = celltree.overlap_areas_device(qi[~big], ti[~big], query_xy, np.ascontiguousarray(tree_xy[:, :40]), device)
    on_cpu = celltree.overlap_areas_device(qi[big], ti[big], query_xy, tree_xy, "cpu")
    # Areas of coordinates up to 40 carry absolute rounding of about
    # 1e-12 (shoelace terms of 1600); the host clip is another algorithm.
    err_host = compare(torch.from_numpy(cut), torch.from_numpy(host), False, 1e-9, 1e-10)
    err_width = compare(torch.from_numpy(on_card[~big]), torch.from_numpy(cut), False, 1e-9, 1e-10)
    err_cpu = compare(torch.from_numpy(on_card[big]), torch.from_numpy(on_cpu), False, 1e-9, 1e-10)
    regridder = xt.OverlapRegridder(mesh, raster, device=device)
    w = regridder._weights
    sums = np.bincount(w.indices, weights=w.data, minlength=mesh.n_face)
    inside = ((mesh.celltree.bb_coords[:, :2] >= 0.0) & (mesh.celltree.bb_coords[:, 2:] <= 40.0)).all(axis=1)
    area_err = float(np.max(np.abs(sums[inside] - mesh.area[inside]) / mesh.area[inside]))
    if area_err > 1e-9:
        raise AssertionError(f"over-cap overlap: a face's areas sum to its area within rtol {area_err:.3e}")
    print(
        f"  over-cap overlap ({int(big.sum())} pairs on 120-node faces, {int((~big).sum())} on quads and 40-node "
        f"faces): card {card_s:.4f} s; vs native padded clip max |diff| {err_host:.3e}, vs the 40-column buffer "
        f"{err_width:.3e}, 120-node pairs vs the CPU {err_cpu:.3e}; OverlapRegridder on the card nnz {w.nnz}, "
        f"each face's areas sum to its area within rtol {area_err:.3e} [{card}]"
    )
    rng = np.random.default_rng(9)
    centers = np.array([[6.0, 6.0], [20.0, 9.0], [30.0, 30.0], [12.0, 28.0], [35.5, 2.5]])
    points = np.concatenate([c + rng.uniform(-1.5, 1.5, (2000, 2)) for c in centers])
    points = np.concatenate([points, nodes[-120:][:5]])
    face = mesh.locate_points(points)
    tol = mesh.celltree.default_tolerance()
    big = n_nodes[np.maximum(face, 0)] > 40
    t0 = time.perf_counter()
    _, weights = mesh.compute_barycentric_weights(points, device=device)
    card_s = time.perf_counter() - t0
    host = native.mean_value_weights_native(points[~big], face[~big].astype(np.int64),
                                            np.ascontiguousarray(tree_xy[:, :40]), tol)
    on_cpu = celltree.mean_value_weights_device(points[big], face[big], tree_xy, tol, "cpu")
    err_host = compare(torch.from_numpy(weights[~big][:, :40]), torch.from_numpy(host), False, 1e-12, 1e-12)
    err_cpu = compare(torch.from_numpy(weights[big]), torch.from_numpy(on_cpu), False, 1e-12, 1e-12)
    row_err = float(np.abs(weights[face >= 0].sum(axis=1) - 1.0).max())
    if row_err > 1e-12 or weights[~big][:, 40:].any():
        raise AssertionError(f"over-cap mean-value weights: rows sum to 1 within {row_err:.3e}")
    print(
        f"  over-cap mean-value weights ({int(big.sum())} points in 120-node faces, {int((~big).sum())} in others): "
        f"card {card_s:.4f} s; vs native max |diff| {err_host:.3e}, 120-node rows vs the CPU {err_cpu:.3e}; rows "
        f"sum to 1 within {row_err:.3e} [{card}]"
    )


def phase_labelled(device, card, inputs, meshes):
    """Phase 8: labelled arrays and structured grids at the 1M config,
    through the entry points a user calls, on the card.  Returns (launch
    counts, largest |kernel - plain| per kernel, apply times keyed by
    (label, E))."""
    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.regrid.structured import StructuredGrid2d
    from xugrid_tpu_torch.ugrid import interpolate
    from xugrid_tpu_torch.utils.profiling import timings

    (verts, faces), _, mesh_data = inputs
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    payload = torch.from_numpy(mesh_data).to(device)
    uda = xt.UgridDataArray(
        xt.xdata.DataArray(payload, dims=("time", mesh.face_dimension), coords={"time": np.arange(N_EXTRA)}, name="v"),
        mesh,
    )
    target = raster_dataarray(T_SIDE, np.zeros((T_SIDE, T_SIDE), np.float32))
    grid = StructuredGrid2d(target)
    kernels = (window_reduce, window_select, csr_matvec)
    # Launches of the path's own calls (the labelled regrids and fills),
    # not of the comparisons and timings beside them.
    counts = {k.__name__: 0 for k in kernels}
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    scale = float(np.nanmax(np.abs(mesh_data)))
    print(f"phase 8: UgridDataArray (time={N_EXTRA}, face={mesh.n_face}) float32 on the card -> "
          f"{T_SIDE} x {T_SIDE} raster DataArray, y descending [{card}]")

    def run(regridder, source):
        before = {k.__name__: k.launches for k in kernels}
        out = regridder.regrid(source)
        torch.cuda.synchronize()
        rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
        for name, n in rose.items():
            counts[name] += n
        return out, rose

    # 8.1: mesh -> raster, a labelled target.
    directional = xt.Ugrid2d.from_structured_bounds(grid.xbounds.directional_bounds, grid.ybounds.directional_bounds)
    sample = np.sort(np.random.default_rng(8).choice(T_SIDE * T_SIDE, size=min(400, T_SIDE * T_SIDE), replace=False))
    for cls, method, kernel in (
        (xt.OverlapRegridder, "mean", window_reduce),
        (xt.OverlapRegridder, "mode", window_select),
        (xt.RelativeOverlapRegridder, "first_order_conservative", window_reduce),
    ):
        label = f"{cls.__name__}({method}) mesh -> raster"
        timings.reset()
        t0 = time.perf_counter()
        regridder = cls(uda, target, method=method)
        build_stages(label, time.perf_counter() - t0)
        out, rose = run(regridder, uda)
        check_labelled(label, out, target, N_EXTRA, device)
        flat = out.data.reshape(N_EXTRA, -1)
        csr = regridder._weights
        if kernel is window_reduce:
            reference = lambda got, csr=csr, m=method: (got, reference_linear(csr, mesh_data, relative=m != "mean"))  # noqa: E731
        else:
            reference = lambda got, csr=csr: (got[:, sample], reference_select(csr, mesh_data, sample, "mode"))  # noqa: E731
        err = check_apply(label, regridder, payload, flat, kernel, rose, scale, reference)
        max_err[kernel.__name__] = max(max_err[kernel.__name__], err)
        bare = cls(mesh, directional, method=method).regrid(payload)
        compare(out.data, bare.reshape(out.shape), True, 0.0, 0.0)
        if method == "mean":
            ascending = xt.Ugrid2d.from_structured_bounds(grid.xbounds.bounds, grid.ybounds.bounds)
            flipped = cls(mesh, ascending, method=method).regrid(payload).reshape(out.shape).flip(1)
            rtol, atol = tolerance(torch.float32, scale)
            compare(out.data, flipped, False, rtol, atol)
        labelled_ms = cuda_time_ms(lambda: regridder.regrid(uda))
        bare_ms = cuda_time_ms(lambda: regridder.regrid(payload))
        labelled_us, bare_us = host_us(lambda: regridder.regrid(uda)), host_us(lambda: regridder.regrid(payload))
        print(
            f"  {label}: bit-equal to the bare regrid onto Ugrid2d.from_structured_bounds, reshaped"
            f"{' (and to the ascending raster flipped along y, float32 tolerance)' if method == 'mean' else ''}; "
            f"apply pass labelled {labelled_ms:.6f} ms, bare {bare_ms:.6f} ms back to back; host "
            f"{labelled_us:.1f} us against {bare_us:.1f} us per call [{card}]"
        )

    # 8.2: raster -> raster.
    rng = np.random.default_rng(23)
    fine = rng.normal(size=(N_EXTRA, RASTER_SIDE, RASTER_SIDE)).astype(np.float32)
    fine[rng.random(fine.shape) < 0.01] = np.nan
    source = raster_dataarray(RASTER_SIDE, torch.from_numpy(fine).to(device))
    fine_flat = fine.reshape(N_EXTRA, -1)
    fine_payload = source.data.reshape(N_EXTRA, -1)
    print(f"  raster -> raster: {RASTER_SIDE} x {RASTER_SIDE} (time={N_EXTRA}) float32 on the card -> {T_SIDE} x {T_SIDE}")
    timing_runs = []
    for cls, kwargs, kernel, timing_label in (
        (xt.OverlapRegridder, {"method": "mean"}, window_reduce, "overlap mean raster->raster"),
        (xt.RelativeOverlapRegridder, {"method": "first_order_conservative"}, window_reduce, None),
        (xt.BarycentricInterpolator, {}, window_reduce, "bilinear raster->raster"),
        (xt.CentroidLocatorRegridder, {}, None, None),
    ):
        label = f"{cls.__name__} raster -> raster"
        timings.reset()
        t0 = time.perf_counter()
        regridder = cls(source, target, **kwargs)
        build_stages(label, time.perf_counter() - t0)
        out, rose = run(regridder, source)
        check_labelled(label, out, target, N_EXTRA, device)
        w = regridder._weights
        flat = out.data.reshape(N_EXTRA, -1)
        if kernel is None:
            if any(rose.values()):
                raise AssertionError(f"{label} launched kernels: {rose}")
            want = np.full((N_EXTRA, w.n), np.nan, dtype=np.float32)
            want[:, w.row] = fine_flat[:, w.col]
            compare(flat, torch.from_numpy(want), True, 0.0, 0.0)
            print(f"  {label}: {w.nnz} of {w.n} targets located; no launch; bit-equal to numpy out[:, row] = data[:, col]")
            continue
        relative = cls is xt.RelativeOverlapRegridder
        err = check_apply(
            label, regridder, fine_payload, flat, kernel, rose, float(np.nanmax(np.abs(fine))),
            lambda got, w=w, relative=relative: (got, reference_linear(w, fine_flat, relative=relative)),
        )
        max_err["window_reduce"] = max(max_err["window_reduce"], err)
        if relative:
            per_source = np.bincount(w.indices, weights=w.data, minlength=w.m)
            sum_err = float(np.abs(per_source - 1.0).max())
            if sum_err > 1e-12:
                raise AssertionError(f"{label}: a source cell's weights sum to 1 + {sum_err:.3e}")
            print(f"  {label}: every source cell's weights sum to 1 within {sum_err:.3e}")
        if cls is xt.BarycentricInterpolator:
            field = lambda x, y: 2.0 * x + 3.0 * y + 1.0  # noqa: E731
            sy, sx = np.meshgrid(source["y"].values, source["x"].values, indexing="ij")
            linear = raster_dataarray(RASTER_SIDE, torch.from_numpy(field(sx, sy).astype(np.float32)[None]).to(device))
            got = regridder.regrid(linear).values[0].astype(np.float64)
            ty, tx_ = np.meshgrid(target["y"].values, target["x"].values, indexing="ij")
            rel = float(np.max(np.abs(got - field(tx_, ty)) / np.abs(field(tx_, ty))))
            if not np.isfinite(got).all() or rel > 1e-5:
                raise AssertionError(f"{label}: linear field off by rtol {rel:.3e}")
            print(f"  {label}: linear field 2x + 3y + 1 (float32) comes back within rtol {rel:.3e} (gate 1e-5)")
        if timing_label:
            timing_runs.append((cls, timing_label, kernel, regridder))

    # 8.3: the accessor's fill over 20 slices sharing one NaN pattern.
    W, labels, values, truth = meshes["delaunay"]
    dgrid = meshes["delaunay_grid"]
    stack = np.where(
        np.isnan(values)[None, :], np.nan, truth[None, :] * (1.0 + 0.05 * np.arange(LAPLACE_SLICES))[:, None]
    )
    filled_uda = xt.UgridDataArray(xt.xdata.DataArray(stack, dims=("time", dgrid.node_dimension)), dgrid)
    solve = {"xy_weights": False, "atol": LAPLACE_SOLVE["atol"], "rtol": LAPLACE_SOLVE["rtol"],
             "maxiter": LAPLACE_SOLVE["maxiter"]}
    before = csr_matvec.launches
    timings.reset()
    t0 = time.perf_counter()
    filled = filled_uda.ugrid.laplace_interpolate(**solve)
    wall = time.perf_counter() - t0
    info = dict(interpolate.last_solve_info)
    stages = "; ".join(f"{name} {rec['total_s']:.3f} s" for name, rec in timings.summary().items())
    launches = csr_matvec.launches - before
    expected = 1 + 3 + info["iterations"] * 4
    if launches != expected:
        raise AssertionError(f"accessor fill: csr_matvec launches {launches}, one batched solve makes {expected}")
    direct = interpolate.laplace_interpolate(stack, W, components_labels=labels, precondition_degree=4, **LAPLACE_SOLVE)
    if filled.dims != ("time", dgrid.node_dimension):
        raise AssertionError(f"accessor fill: dims {filled.dims}")
    compare(torch.from_numpy(filled.values), torch.from_numpy(direct), True, 0.0, 0.0)
    residual = unknown_residuals(W, stack, filled.values)
    if residual.max() > 10 * LAPLACE_SOLVE["atol"]:
        raise AssertionError(f"accessor fill: host residual {residual.max():.3e} > 10 * atol")
    on_card = xt.UgridDataArray(filled_uda.obj.copy(data=torch.from_numpy(stack).to(device)), dgrid)
    before_card = csr_matvec.launches
    t1 = time.perf_counter()
    card_filled = on_card.ugrid.laplace_interpolate(**solve)
    card_wall = time.perf_counter() - t1
    counts["csr_matvec"] = launches + csr_matvec.launches - before_card
    if not (isinstance(card_filled.data, torch.Tensor) and card_filled.data.device == device):
        raise AssertionError("accessor fill of a CUDA payload did not return a tensor on the card")
    compare(card_filled.data, torch.from_numpy(direct), True, 0.0, 0.0)
    print(
        f"  uda.ugrid.laplace_interpolate (time={LAPLACE_SLICES}, node={dgrid.n_node}, one NaN pattern): one batched "
        f"solve, {info['iterations']} iterations, csr_matvec +{launches}, last_solve_info {json.dumps(info)}; equal "
        f"to the direct call; host residual max {residual.max():.3e}; wall {wall:.3f} s (accessor stages: {stages}; "
        f"the solve's host {info['host_s']:.3f} s: {host_stages(info)}; device {info['device_s']:.3f} s); the same on "
        f"a CUDA payload {card_wall:.3f} s (solve cached: {interpolate.last_solve_info['cached']}), a CUDA tensor "
        f"back, equal [{card}]"
    )

    # 8.4: faces above the native caps.
    phase_overcap(device, card)
    timed, _ = phase_timing(device, timing_runs, card, title="phase 8 apply times")
    return counts, max_err, timed


def path_mb(path):
    """Megabytes of a file, or of every file under a directory."""
    import os

    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files) / 1e6
    return os.path.getsize(path) / 1e6


def phase7_network():
    """Phase 7's network and edge data: the same seed and the same draws
    before them."""
    import xugrid_tpu_torch as xt

    rng = np.random.default_rng(17)
    rng.normal(size=(N_EXTRA, T_SIDE * T_SIDE))
    rng.random((N_EXTRA, T_SIDE * T_SIDE))
    nodes, edges = random_network(NETWORK_LINES, NETWORK_SEGMENTS, float(N_SIDE), rng)
    network = xt.Ugrid1d(nodes[:, 0], nodes[:, 1], -1, edges)
    values = (np.round(rng.normal(size=(N_EXTRA, network.n_edge)) * 2.0) / 2.0).astype(np.float32)
    values[rng.random(values.shape) < 0.01] = np.nan
    return network, values


def weights_bit_equal(label, got, want):
    """Two weight matrices (CSR or COO) with equal fields, bit for bit."""
    for field, a, b in zip(want._fields, got, want):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"{label}: the reloaded weights' {field} differs from the stored one")


def phase_files(device, card, inputs, timed):
    """Phase 9: UGRID files and stored weights at the 1M config, on the
    card, in a temporary directory removed at the end: phase 3's mesh
    with a (time, face) float32 payload on the card written through
    ``.ugrid.to_netcdf`` and ``.ugrid.to_zarr`` and opened with
    ``xt.open_dataset`` / ``xt.open_zarr``; OverlapRegridder (mean,
    mode) and BarycentricInterpolator mesh -> raster and phase 7's
    NetworkGridder (mean) stored with ``to_dataset().to_netcdf`` and
    rebuilt with ``from_dataset``, each regrid of the opened data on the
    card one launch, bit-equal to the fresh regridder's; and the raster
    result written and read back.  Returns (launch counts of the
    reloaded regridders' passes, largest |kernel - plain| per kernel)."""
    import os
    import shutil
    import tempfile

    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select

    (verts, faces), _, mesh_data = inputs
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    times = np.datetime64("2020-01-01T00:00", "ns") + np.arange(N_EXTRA) * np.timedelta64(6, "h")
    payload = torch.from_numpy(mesh_data).to(device)
    uda = xt.UgridDataArray(
        xt.xdata.DataArray(payload, dims=("time", mesh.face_dimension), coords={"time": times},
                           name="temperature", attrs={"units": "degC"}),
        mesh,
    )
    kernels = (window_reduce, window_select, csr_matvec)
    counts = {k.__name__: 0 for k in kernels}
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    scale = float(np.nanmax(np.abs(mesh_data)))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    print(f"phase 9: UGRID files and stored weights, mesh {mesh.n_face} faces, (time={N_EXTRA}, face) float32 on "
          f"the card [{card}]")

    def run(regridder, source):
        before = {k.__name__: k.launches for k in kernels}
        t0 = time.perf_counter()
        out = regridder.regrid(source)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
        for name, n in rose.items():
            counts[name] += n
        return out, rose, first_s

    try:
        # 9.1: the mesh and its payload to netCDF and zarr, and back.
        try:
            np.asarray(uda.obj)
        except TypeError:
            pass
        else:
            raise AssertionError("a DataArray over a CUDA tensor converted to numpy implicitly")
        opened = {}
        for fmt, writer, opener in (("netCDF", "to_netcdf", xt.open_dataset), ("zarr", "to_zarr", xt.open_zarr)):
            path = os.path.join(tmp, "mesh_1M.nc" if fmt == "netCDF" else "mesh_1M.zarr")
            t0 = time.perf_counter()
            getattr(uda.ugrid, writer)(path)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            uds = opener(path)
            open_s = time.perf_counter() - t0
            grid = uds.grid
            if not grid.equals(mesh):
                raise AssertionError(f"{fmt}: the opened grid does not equal the one written")
            for name in ("node_x", "node_y", "face_node_connectivity"):
                if not np.array_equal(getattr(grid, name), getattr(mesh, name)):
                    raise AssertionError(f"{fmt}: {name} differs from the one written")
            back = uds["temperature"]
            if not isinstance(back.data, np.ndarray) or not back.data.dtype.isnative:
                raise AssertionError(f"{fmt}: the opened payload is not a native host array")
            if back.dims != uda.dims or not np.array_equal(back.values, mesh_data, equal_nan=True):
                raise AssertionError(f"{fmt}: the opened payload differs from the one written")
            if not np.array_equal(back.obj["time"].values, times):
                raise AssertionError(f"{fmt}: the time coordinate differs from the one written")
            if uda.data.device != device:
                raise AssertionError(f"{fmt}: writing moved the payload off the card")
            opened[fmt] = uds
            print(
                f"  9.1 {fmt}: {path_mb(path):.3f} MB written in {write_s:.3f} s (the CUDA payload through an "
                f"explicit host copy), opened in {open_s:.3f} s; grid equal, connectivity, node coordinates and "
                f"data bit-equal, time coordinate datetime64 equal [{card}]"
            )

        # 9.2: stored weights mesh -> raster, regridding the opened data.
        source = opened["netCDF"]["temperature"]
        on_card = xt.UgridDataArray(source.obj.copy(data=torch.from_numpy(source.values).to(device)), source.grid)
        flat = on_card.data
        target = raster_dataarray(T_SIDE, np.zeros((T_SIDE, T_SIDE), np.float32))
        sample = np.sort(np.random.default_rng(9).choice(T_SIDE * T_SIDE, size=min(400, T_SIDE * T_SIDE), replace=False))
        mean_out = None
        for cls, kwargs, kernel, phase4 in (
            (xt.OverlapRegridder, {"method": "mean"}, window_reduce, "mean"),
            (xt.OverlapRegridder, {"method": "mode"}, window_select, "mode"),
            (xt.BarycentricInterpolator, {}, window_reduce, None),
        ):
            label = f"{cls.__name__}({kwargs.get('method', 'mean')}) mesh -> raster"
            t0 = time.perf_counter()
            fresh = cls(source, target, **kwargs)
            build_s = time.perf_counter() - t0
            path = os.path.join(tmp, "weights.nc")
            t0 = time.perf_counter()
            fresh.to_dataset().to_netcdf(path)
            store_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded = cls.from_dataset(xt.xdata.open_dataset(path), **kwargs)
            load_s = time.perf_counter() - t0
            weights_bit_equal(label, loaded._weights, fresh._weights)
            out, rose, first_s = run(loaded, on_card)
            if out.dims != ("time", "y", "x") or not isinstance(out.data, torch.Tensor) or out.data.device != device:
                raise AssertionError(f"{label}: {out.dims}, payload {type(out.data).__name__} not on {device}")
            for name, want in (("time", times), ("y", target["y"].values), ("x", target["x"].values)):
                if not np.array_equal(out[name].values, want):
                    raise AssertionError(f"{label}: coordinate {name} differs")
            csr = loaded._weights
            if kernel is window_reduce:
                reference = lambda got, csr=csr: (got, reference_linear(csr, mesh_data, relative=False))  # noqa: E731
            else:
                reference = lambda got, csr=csr: (got[:, sample], reference_select(csr, mesh_data, sample, "mode"))  # noqa: E731
            err = check_apply(label, loaded, flat, out.data.reshape(N_EXTRA, -1), kernel, rose, scale, reference)
            max_err[kernel.__name__] = max(max_err[kernel.__name__], err)
            t0 = time.perf_counter()
            fresh_out = fresh.regrid(on_card)
            torch.cuda.synchronize()
            fresh_first_s = time.perf_counter() - t0
            compare(out.data, fresh_out.data, True, 0.0, 0.0)
            loaded_ms = cuda_time_ms(lambda: loaded.regrid(on_card))
            fresh_ms = cuda_time_ms(lambda: fresh.regrid(on_card))
            kernel_ms = f"{timed[(phase4, N_EXTRA)]['ms']:.6f} ms" if phase4 else "not timed there"
            print(
                f"  9.2 {label}: build {build_s:.3f} s; stored ({path_mb(path):.3f} MB netCDF) in {store_s:.3f} s; "
                f"reloaded with from_dataset in {load_s:.3f} s; weights bit-equal (nnz {csr.nnz}); regrid of the "
                f"opened data on the card bit-equal to the fresh regridder's; first apply pass (the padded "
                f"weights' upload included) {first_s:.4f} s reloaded, {fresh_first_s:.4f} s fresh; back to back {loaded_ms:.6f} ms "
                f"reloaded, {fresh_ms:.6f} ms fresh; phase 4's kernel at E={N_EXTRA} {kernel_ms} [{card}]"
            )
            if kwargs.get("method") == "mean":
                mean_out = out

        # 9.3: phase 7's network gridder (mean), stored and reloaded.
        network, values = phase7_network()
        edge_uda = xt.UgridDataArray(
            xt.xdata.DataArray(torch.from_numpy(values).to(device), dims=("time", network.edge_dimension)), network
        )
        label = "NetworkGridder(mean)"
        t0 = time.perf_counter()
        fresh = xt.NetworkGridder(network, mesh, method="mean")
        build_s = time.perf_counter() - t0
        path = os.path.join(tmp, "network_weights.nc")
        t0 = time.perf_counter()
        fresh.to_dataset().to_netcdf(path)
        store_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = xt.NetworkGridder.from_dataset(xt.xdata.open_dataset(path))
        load_s = time.perf_counter() - t0
        weights_bit_equal(label, loaded._weights, fresh._weights)
        out, rose, first_s = run(loaded, edge_uda)
        csr = loaded._weights
        err = check_apply(
            label, loaded, edge_uda.data, out.data, window_reduce, rose, float(np.nanmax(np.abs(values))),
            lambda got, csr=csr: (got, reference_linear(csr, values, relative=False)),
        )
        max_err["window_reduce"] = max(max_err["window_reduce"], err)
        compare(out.data, fresh.regrid(edge_uda).data, True, 0.0, 0.0)
        print(
            f"  9.3 {label} ({network.n_edge} edges -> {mesh.n_face} faces): build {build_s:.3f} s; stored "
            f"({path_mb(path):.3f} MB) in {store_s:.3f} s; reloaded in {load_s:.3f} s; weights bit-equal; regrid on "
            f"the card bit-equal to the fresh gridder's, first pass {first_s:.4f} s [{card}]"
        )

        # 9.4: the raster result to netCDF and back.
        path = os.path.join(tmp, "raster.nc")
        t0 = time.perf_counter()
        mean_out.to_dataset(name="temperature").to_netcdf(path)
        write_s = time.perf_counter() - t0
        back = xt.xdata.open_dataset(path)["temperature"]
        if back.dims != mean_out.dims or not np.array_equal(back.values, mean_out.values, equal_nan=True):
            raise AssertionError("raster result: read back differs from the one written")
        for name in ("time", "y", "x"):
            if not np.array_equal(back[name].values, mean_out[name].values):
                raise AssertionError(f"raster result: coordinate {name} differs")
        print(
            f"  9.4 raster result (time={N_EXTRA}, y={T_SIDE}, x={T_SIDE}) on the card: {path_mb(path):.3f} MB "
            f"written in {write_s:.3f} s, read back bit-equal with its time, y and x [{card}]"
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if counts["csr_matvec"] or counts["window_reduce"] != 3 or counts["window_select"] != 1:
        raise AssertionError(f"phase 9 launched {counts}")
    return counts, max_err


def stage_line(prefix):
    """The recorded host stages whose name starts with ``prefix``
    (``timings.summary()``), as "name s" pairs."""
    from xugrid_tpu_torch.utils.profiling import timings

    return ", ".join(
        f"{name} {rec['total_s']:.3f} s" for name, rec in timings.summary().items() if name.startswith(prefix)
    )


def check_merged(label, merged, mesh, values, device):
    """A merged 1M dataset against the unpartitioned one: the same node,
    face and edge counts, and under the original positions that the merge
    carried along (the position coordinates of the UGRID dimensions),
    every face's node coordinates and every payload value bit-equal on
    all three dimensions.  ``device`` None: a host payload is expected,
    else a tensor on it."""
    grid = merged.grid
    sizes = (grid.n_face, grid.n_node, grid.n_edge)
    if sizes != (mesh.n_face, mesh.n_node, mesh.n_edge):
        raise AssertionError(f"{label}: merged sizes {sizes} differ from the mesh's")
    index = {dim: merged.obj[dim].values for dim in (grid.face_dimension, grid.node_dimension, grid.edge_dimension)}
    for dim, idx in index.items():
        if not np.array_equal(np.sort(idx), np.arange(mesh.sizes[dim])):
            raise AssertionError(f"{label}: the merged {dim} is not a permutation of the original's")
    face, node, edge = index[grid.face_dimension], index[grid.node_dimension], index[grid.edge_dimension]
    for name, got, want in (
        ("face node x", grid.node_x[grid.face_node_connectivity], mesh.node_x[mesh.face_node_connectivity[face]]),
        ("face node y", grid.node_y[grid.face_node_connectivity], mesh.node_y[mesh.face_node_connectivity[face]]),
        ("node x", grid.node_x, mesh.node_x[node]),
        ("edge node x", grid.node_x[grid.edge_node_connectivity], mesh.node_x[mesh.edge_node_connectivity[edge]]),
        ("edge node y", grid.node_y[grid.edge_node_connectivity], mesh.node_y[mesh.edge_node_connectivity[edge]]),
    ):
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: {name} differ from the original's under the merge's positions")
    for name, want in (
        ("temperature", values["temperature"][:, face]),
        ("edge_v", values["edge_v"][edge]),
        ("node_v", values["node_v"][node]),
    ):
        data = merged.obj[name].data
        on_device = getattr(data, "device", None)
        if (device is None) != isinstance(data, np.ndarray) or (device is not None and on_device != device):
            raise AssertionError(f"{label}: {name} payload is {type(data).__name__} on {on_device}")
        got = merged.obj[name].values
        if got.dtype != want.dtype or not np.array_equal(got, want, equal_nan=True):
            raise AssertionError(f"{label}: {name} differs from the original's under the merge's positions")


def phase_partitions(device, card, inputs, main_results):
    """Phase 10: a partitioned 1M run merged and regridded on the card.
    Phase 3's mesh as a UgridDataset with (time, face) float32, (edge,)
    and (node,) float64 payloads on the card, split by
    ``uds.ugrid.partition(n_part=4)``, each partition written to a UGRID
    netCDF file (the per-rank map files of a partitioned model run) and
    opened; ``xt.merge_partitions`` of the in-memory partitions and of the
    opened files each rebuilds the mesh (``check_merged``); both merged
    temperatures regridded onto phase 3's 512 x 512 raster by
    ``OverlapRegridder`` mean (window_reduce) and median (window_select),
    one launch each, held to the plain version and the host references,
    the median bit-equal and the mean within float32 summation error of
    phase 3's unpartitioned regrid.  Times the partition, the files, the
    merge by stage, ``unique_rows`` at the merge's sizes (the native hash
    and the torch grouping on the card) and the regrid passes.  Returns
    (launch counts of the four regrids, largest |kernel - plain| per
    kernel)."""
    import os
    import shutil
    import tempfile

    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.core.dedup import _group_rows_device, _to_u32_columns, unique_rows
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.apply import device_weights
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.utils.profiling import timings

    (verts, faces), (tverts, tfaces), mesh_data = inputs
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    rng = np.random.default_rng(10)
    t0 = time.perf_counter()
    n_edge = mesh.n_edge
    edges_s = time.perf_counter() - t0
    values = {
        "temperature": mesh_data,
        "edge_v": rng.normal(size=n_edge),
        "node_v": rng.normal(size=mesh.n_node),
    }
    dims = {
        "temperature": ("time", mesh.face_dimension),
        "edge_v": (mesh.edge_dimension,),
        "node_v": (mesh.node_dimension,),
    }
    ds = xt.xdata.Dataset({name: (dims[name], torch.from_numpy(v).to(device)) for name, v in values.items()})
    uds = xt.UgridDataset(ds, grids=[mesh])
    print(
        f"phase 10: partition, files and merge_partitions of the 1M mesh ({mesh.n_face} faces, {mesh.n_node} nodes, "
        f"{n_edge} edges derived in {edges_s:.3f} s), (time={N_EXTRA}, face) float32, (edge,) and (node,) float64 "
        f"on the card [{card}]"
    )
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0

    # 10.1: the partition.
    timings.reset()
    t0 = time.perf_counter()
    parts = uds.ugrid.partition(n_part=4)
    torch.cuda.synchronize()
    partition_s = time.perf_counter() - t0
    for part in parts:
        for name in values:
            if part.obj[name].data.device != device:
                raise AssertionError(f"partition: {name} left the card")
    print(
        f"  10.1 uds.ugrid.partition(n_part=4): {partition_s:.3f} s ({stage_line('partition.')}); faces per part "
        f"{[p.grid.n_face for p in parts]}, nodes {[p.grid.n_node for p in parts]}, edges "
        f"{[p.grid.n_edge for p in parts]}; payloads stay on the card [{card}]"
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_partitions_")
    try:
        # 10.2: each partition as a map file, and back.
        opened, write_s, open_s, mb = [], [], [], []
        for i, part in enumerate(parts):
            path = os.path.join(tmp, f"map_{i:04d}_map.nc")
            t0 = time.perf_counter()
            part.ugrid.to_netcdf(path)
            write_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            opened.append(xt.open_dataset(path))
            open_s.append(time.perf_counter() - t0)
            mb.append(path_mb(path))
        print(
            f"  10.2 partition files (netCDF): {', '.join(f'{m:.3f}' for m in mb)} MB; written in "
            f"{', '.join(f'{s:.3f}' for s in write_s)} s, opened in {', '.join(f'{s:.3f}' for s in open_s)} s [{card}]"
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10.3: the merges.
    merged = {}
    for label, partitions, on in (("in-memory", parts, device), ("files", opened, None)):
        timings.reset()
        t0 = time.perf_counter()
        merged[label] = xt.merge_partitions(partitions)
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        check_merged(label, merged[label], mesh, values, on)
        print(
            f"  10.3 merge_partitions ({label}, payload {'on the card' if on else 'numpy'}): {merge_s:.3f} s "
            f"({stage_line('merge.')}); n_face, n_node, n_edge equal; face node coordinates and the face, edge and "
            f"node payloads bit-equal under the merge's positions [{card}]"
        )

    # 10.4: unique_rows at the merge's sizes: the native hash against the
    # torch grouping on the card.
    node_rows = np.column_stack([np.concatenate([p.grid.node_x for p in parts]),
                                 np.concatenate([p.grid.node_y for p in parts])])
    face_rows = np.concatenate(
        [p.obj[mesh.node_dimension].values[p.grid.face_node_connectivity] for p in parts]
    )
    for label, rows in (("node rows", node_rows), ("face rows", face_rows)):
        host_s, card_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            host = unique_rows(rows)
            host_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            on_card = unique_rows(rows, device=device)
            card_s.append(time.perf_counter() - t0)
        if not all(np.array_equal(a, b) for a, b in zip(host, on_card)):
            raise AssertionError(f"unique_rows {label}: the torch grouping on the card differs from the native hash")
        cols = torch.from_numpy(_to_u32_columns(rows).astype(np.int64)).to(device)
        group_ms = cuda_time_ms(lambda cols=cols: _group_rows_device(cols), reps=5, warmup=1, inner=1)
        print(
            f"  10.4 unique_rows {label} {rows.shape} {rows.dtype} ({cols.shape[1]} u32 keys, {len(host[0])} unique): "
            f"native hash {statistics.median(host_s) * 1e3:.3f} ms; torch grouping on the card "
            f"{statistics.median(card_s) * 1e3:.3f} ms with the copies, {group_ms:.3f} ms of it the grouping on "
            f"resident keys; equal [{card}]"
        )

    # 10.5: both merged temperatures regridded, against phase 3's
    # unpartitioned regrids.
    unpartitioned = {method: out for _, method, _, _, out, *_ in main_results}
    scale = float(np.nanmax(np.abs(mesh_data)))
    sample = np.sort(np.random.default_rng(9).choice(target.n_face, size=min(400, target.n_face), replace=False))
    counts = {k.__name__: 0 for k in kernels}
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    regridders = []
    for label in ("in-memory", "files"):
        temperature = merged[label]["temperature"]
        source = torch.from_numpy(temperature.values).to(device)
        merged_data = temperature.values
        for method, kernel in (("mean", window_reduce), ("median", window_select)):
            t0 = time.perf_counter()
            regridder = xt.OverlapRegridder(temperature, target, method=method)
            build_s = time.perf_counter() - t0
            before = {k.__name__: k.launches for k in kernels}
            t0 = time.perf_counter()
            out = regridder.regrid(temperature)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
            for name, n in rose.items():
                counts[name] += n
            if not isinstance(out, xt.UgridDataArray) or out.data.device != device:
                raise AssertionError(f"{label} {method}: {type(out).__name__} not on the card")
            csr = regridder._weights
            if kernel is window_reduce:
                reference = lambda got, csr=csr, d=merged_data: (got, reference_linear(csr, d, relative=False))  # noqa: E731
            else:
                reference = lambda got, csr=csr, d=merged_data: (  # noqa: E731
                    got[:, sample], reference_select(csr, d, sample, "median")
                )
            err = check_apply(f"10.5 {label} {method}", regridder, source, out.data, kernel, rose, scale, reference)
            max_err[kernel.__name__] = max(max_err[kernel.__name__], err)
            if kernel is window_select:
                diff = compare(out.data, unpartitioned[method], True, 0.0, 0.0)
                how = "bit-equal to"
            else:
                rtol, atol = tolerance(torch.float32, scale)
                idx, w = device_weights(regridder._padded, torch.float32, device, regridder._device_weights)
                bound = torch.clamp(summation_bound(source, idx, w, regridder._reduction), min=atol)
                diff = compare(out.data, unpartitioned[method], False, rtol, bound)
                how = f"within rtol {rtol} and the float32 summation bound (at least {atol:.3e}) of"
            print(
                f"       {label} {method}: build {build_s:.3f} s, first pass {first_s:.4f} s; {how} the unpartitioned "
                f"regrid (phase 3), max |diff| {diff:.3e} [{card}]"
            )
            regridders.append((label, method, regridder, temperature))
    if counts != {"window_reduce": 2, "window_select": 2, "csr_matvec": 0}:
        raise AssertionError(f"phase 10 launched {counts}")
    for label, method, regridder, temperature in regridders:
        if label == "in-memory":
            ms = cuda_time_ms(lambda r=regridder, t=temperature: r.regrid(t))
            print(f"  10.6 regrid of the merged temperature ({method}), back to back: {ms:.6f} ms per pass [{card}]")
    return counts, max_err


QUERY_POINTS = 100_000
THRESHOLD_SHAPE = (32_768, 2_097_152)
STATIONS = 10_000
SECTION_VERTICES = 1_000
FILL_SLICES, FILL_FRACTION = 4, 0.10


def scan_resolution(sources, queries):
    """The float32 scan's distance resolution: its coordinates, shifted to
    the sources' mean, are rounded to half a float32 ulp of the largest
    of them, so two distances may swap order when they differ by less
    than 2 sqrt(2) ulps."""
    origin = sources.mean(axis=0)
    extent = max(np.abs(sources - origin).max(), np.abs(queries - origin).max())
    return 2.0 * np.sqrt(2.0) * float(np.spacing(np.float32(extent)))


def check_nearest(label, sources, queries, got, tree):
    """``got`` against scipy's KDTree over ``sources``: the same index, or
    a source at the same distance within rtol 1e-5 or the scan's float32
    resolution (``scan_resolution``).  Returns (the number of differing
    indices, the largest |distance difference| among them)."""
    _, want = tree.query(queries, workers=-1)
    if got.shape != want.shape or (got < 0).any():
        raise AssertionError(f"{label}: {got.shape} indices, {int((got < 0).sum())} negative")
    diff = got != want
    gap = 0.0
    if diff.any():
        d_want = np.linalg.norm(sources[want[diff]] - queries[diff], axis=1)
        d_got = np.linalg.norm(sources[got[diff]] - queries[diff], axis=1)
        gap = float(np.abs(d_got - d_want).max())
        if not np.allclose(d_got, d_want, rtol=1e-5, atol=scan_resolution(sources, queries)):
            raise AssertionError(
                f"{label}: {int(diff.sum())} indices differ, not all equidistant: largest |distance difference| "
                f"{gap:.3e} at distances {d_want[np.argmax(np.abs(d_got - d_want))]:.6e}; float32 resolution "
                f"{scan_resolution(sources, queries):.3e}"
            )
    return int(diff.sum()), gap


def scan_line(label, sources, queries, device, card):
    """Times the device scan on resident float32 tensors (CUDA events, one
    call per pass, median of 3 after one warm-up) and scipy's KDTree
    (build, then a threaded query) at one shape; prints both with the
    pairs per second and the scan's operations bound (5 float32
    operations per pair at the card's peak)."""
    import torch
    from scipy.spatial import KDTree

    from xugrid_tpu_torch.spatial import nearest

    origin = sources.mean(axis=0)
    q = torch.from_numpy((queries - origin).astype(np.float32)).to(device)
    s = torch.from_numpy((sources - origin).astype(np.float32)).to(device)
    scan_ms = cuda_time_ms(lambda: nearest.scan_tiles(q, s), reps=3, warmup=1, inner=1)
    t0 = time.perf_counter()
    tree = KDTree(sources)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree.query(queries, workers=-1)
    query_s = time.perf_counter() - t0
    pairs = len(queries) * len(sources)
    bound = pairs * 5 / PEAK_FLOPS["float32"] * 1e3
    print(
        f"  11.1 {label}: {len(queries)} x {len(sources)} = {pairs:.4e} pairs; card scan {scan_ms:.3f} ms "
        f"({pairs / scan_ms * 1e3:.4e} pairs/s; chunk {nearest.CHUNK} queries x tile {nearest.TILE}; operations "
        f"bound {bound:.3f} ms); KDTree build {build_s:.4f} s, query {query_s:.4f} s (threaded) [{card}]"
    )
    return {"scan_ms": scan_ms, "kdtree_build_s": build_s, "kdtree_query_s": query_s, "pairs": pairs}


def host_gather(values, index):
    """numpy's gather of ``values`` (..., n) at ``index``, NaN where -1."""
    taken = values[..., np.maximum(index, 0)]
    return np.where(index >= 0, taken, np.nan)


def bit_equal(label, got, want, device):
    """A tensor result on ``device`` equal to the numpy ``want`` bit for
    bit, NaN where NaN."""
    import torch

    if not isinstance(got, torch.Tensor) or got.device != device:
        raise AssertionError(f"{label}: the result is not a tensor on {device}")
    got = got.cpu().numpy()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.shape} {got.dtype}, expected {want.shape} {want.dtype}")
    np.testing.assert_array_equal(got, want, err_msg=label)


def nan_patches(centroids, fraction, rng):
    """Faces in seeded disks until about ``fraction`` of them: gaps in
    the data as a model's dry cells or a satellite's cloud leave them."""
    from scipy.spatial import cKDTree

    extent = centroids.max(axis=0)
    radius = 0.01 * extent[0]
    n_disks = int(fraction * extent[0] * extent[1] / (np.pi * radius**2) * 1.05)
    centers = rng.uniform(0.0, extent, (n_disks, 2))
    distance, _ = cKDTree(centers).query(centroids, distance_upper_bound=radius)
    return np.isfinite(distance)


def phase_queries(device, card, inputs):
    """Phase 11: nearest lookups, point and line selections,
    rasterization, the facet remaps, reindexing and the nearest fill at
    the 1M config, on the card, through the ``.ugrid`` accessor of phase
    3's mesh with its (time, face) float32 payload on the card, and on
    phase 7's network.  Each result is held to a host computation (scipy's
    KDTree, numpy gathers, native point location, scipy's dijkstra);
    the fill is regridded onto the raster (one window_reduce launch).
    Returns (launch counts, largest |kernel - plain|, the scan timings)."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra
    from scipy.spatial import KDTree

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.spatial import nearest
    from xugrid_tpu_torch.utils import native

    (verts, faces), (tverts, tfaces), mesh_data = inputs
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    t0 = time.perf_counter()
    n_edge = mesh.n_edge
    print(
        f"phase 11: queries and the nearest fill on the 1M mesh ({mesh.n_face} faces, {mesh.n_node} nodes, "
        f"{n_edge} edges derived in {time.perf_counter() - t0:.3f} s), (time={N_EXTRA}, face) float32 on the card "
        f"[{card}]"
    )
    uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(mesh_data).to(device), dims=("time", mesh.face_dimension), name="v"), mesh
    )
    rng = np.random.default_rng(11)
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    timed = {}

    # 11.1: nearest node, edge and face of 100,000 points; the card scan
    # (P x M >= 2^36, M <= 2^21) against scipy's KDTree.
    points = rng.uniform(0.0, float(N_SIDE), (QUERY_POINTS, 2))
    for facet in ("node", "edge", "face"):
        sources = mesh.get_coordinates(getattr(mesh, f"{facet}_dimension"))
        t0 = time.perf_counter()
        got = getattr(mesh, f"locate_nearest_{facet}")(points)
        call_s = time.perf_counter() - t0
        n_diff, gap = check_nearest(f"locate_nearest_{facet}", sources, points, got, getattr(mesh, f"{facet}_kdtree"))
        print(
            f"  11.1 locate_nearest_{facet}: {call_s:.3f} s (first call: the grid's KDTree built, the upload and "
            f"the scan); equal to the KDTree's but {n_diff} equidistant (largest |distance difference| {gap:.3e}, "
            f"float32 resolution {scan_resolution(sources, points):.3e}) [{card}]"
        )
        timed[facet] = scan_line(f"{facet} scan", sources, points, device, card)
    n_query, n_source = THRESHOLD_SHAPE
    threshold_sources = rng.uniform(0.0, float(N_SIDE), (n_source, 2))
    threshold_queries = rng.uniform(0.0, float(N_SIDE), (n_query, 2))
    got = nearest.nearest_points(threshold_sources, threshold_queries)
    n_diff, _ = check_nearest("threshold", threshold_sources, threshold_queries, got, KDTree(threshold_sources))
    timed["threshold"] = scan_line(f"threshold 2^36 ({n_diff} equidistant)", threshold_sources, threshold_queries,
                                   device, card)

    # 11.2: sel_points of 10,000 stations, 1 % outside the mesh.
    n_out = STATIONS // 100
    stations = np.concatenate([
        rng.uniform(0.0, float(N_SIDE), (STATIONS - n_out, 2)),
        rng.uniform(N_SIDE + 1.0, N_SIDE + 50.0, (n_out, 2)),
    ])
    x, y = stations[:, 0], stations[:, 1]
    located = mesh.locate_points(stations)
    node_data = rng.normal(size=(N_EXTRA, mesh.n_node)).astype(np.float32)
    node_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(node_data).to(device), dims=("time", mesh.node_dimension), name="h"), mesh
    )
    nearest_face = mesh.face_kdtree.query(stations, workers=-1)[1]
    nearest_node = mesh.node_kdtree.query(stations, workers=-1)[1]
    for label, obj, method, index, values in (
        ("face, containment", uda, None, located, mesh_data),
        ("face, method='nearest'", uda, "nearest", nearest_face, mesh_data),
        ("node", node_uda, None, nearest_node, node_data),
    ):
        t0 = time.perf_counter()
        out = obj.ugrid.sel_points(x, y, method=method, out_of_bounds="ignore")
        torch.cuda.synchronize()
        sel_s = time.perf_counter() - t0
        want = np.where(located >= 0, host_gather(values, index), np.nan).astype(np.float32)
        bit_equal(f"sel_points {label}", out.data, want, device)
        if out.dims != ("time", f"{mesh.name}_points"):
            raise AssertionError(f"sel_points {label}: dims {out.dims}")
        print(
            f"  11.2 sel_points ({label}) of {STATIONS} stations, {int((located < 0).sum())} outside: {sel_s:.4f} s; "
            f"bit-equal to numpy's gather, NaN outside, on the card [{card}]"
        )

    # 11.3: cross-sections.
    walk_nodes, _ = random_network(1, SECTION_VERTICES - 1, float(N_SIDE), rng)
    poly_xy = mesh.celltree._poly_xy_host
    tol = mesh.celltree.default_tolerance()
    for label, call in (
        ("intersect_line (diagonal)", lambda: uda.ugrid.intersect_line((0.0, 0.0), (float(N_SIDE), float(N_SIDE)))),
        (f"sel(x={N_SIDE / 3 + 0.03:.3f}, y=slice(None))", lambda: uda.ugrid.sel(x=N_SIDE / 3 + 0.03, y=slice(None))),
        (f"intersect_linestring ({SECTION_VERTICES} vertices)", lambda: uda.ugrid.intersect_linestring(walk_nodes)),
    ):
        t0 = time.perf_counter()
        section = call()
        torch.cuda.synchronize()
        section_s = time.perf_counter() - t0
        face_index = section[mesh.face_dimension].values
        mid = np.column_stack([section[f"{mesh.name}_x"].values, section[f"{mesh.name}_y"].values])
        s_along = section[f"{mesh.name}_s"].values
        if len(face_index) < N_SIDE:
            raise AssertionError(f"{label}: {len(face_index)} faces")
        inside = native.points_in_polygons_native(mid, face_index, poly_xy, tol)
        if not inside.all():
            raise AssertionError(f"{label}: {int((~inside).sum())} sub-segment midpoints outside their face")
        if (np.diff(s_along) < 0).any():
            raise AssertionError(f"{label}: s decreases")
        bit_equal(label, section.data, mesh_data[:, face_index], device)
        print(
            f"  11.3 {label}: {len(face_index)} faces in {section_s:.4f} s; each face holds its sub-segment's "
            f"midpoint, s non-decreasing to {s_along[-1]:.3f}, values bit-equal to the host gather [{card}]"
        )

    # 11.4: rasterize onto phase 3's 512 x 512 raster, against the
    # centroid locator onto the same raster.
    raster = raster_dataarray(T_SIDE, np.zeros((T_SIDE, T_SIDE)))
    t0 = time.perf_counter()
    rastered = uda.ugrid.rasterize_like(raster)
    torch.cuda.synchronize()
    like_s = time.perf_counter() - t0
    _, _, index = mesh.rasterize_like(raster["x"].values, raster["y"].values)
    bit_equal("rasterize_like", rastered.data, host_gather(mesh_data, index.ravel()).reshape(N_EXTRA, T_SIDE, T_SIDE),
              device)
    locator = xt.CentroidLocatorRegridder(mesh, target)
    located_rows = np.zeros(target.n_face, dtype=bool)
    located_rows[locator._weights.row] = True
    on_target = locator.regrid(uda).data.cpu().numpy()
    # Raster row r (y descending) holds the target faces of row T - 1 - r.
    as_raster = on_target.reshape(N_EXTRA, T_SIDE, T_SIDE)[:, ::-1]
    both = (index >= 0) & located_rows.reshape(T_SIDE, T_SIDE)[::-1]
    np.testing.assert_array_equal(rastered.data.cpu().numpy()[:, both], as_raster[:, both])
    one_only = int((index >= 0).sum() + located_rows.sum() - 2 * both.sum())
    resolution = N_SIDE / T_SIDE
    t0 = time.perf_counter()
    by_resolution = uda.ugrid.rasterize(resolution)
    torch.cuda.synchronize()
    resolution_s = time.perf_counter() - t0
    x_r, y_r, index_r = mesh.rasterize(resolution)
    bit_equal("rasterize", by_resolution.data, host_gather(mesh_data, index_r.ravel()).reshape(N_EXTRA, *index_r.shape),
              device)
    print(
        f"  11.4 rasterize_like ({T_SIDE} x {T_SIDE}): {like_s:.4f} s; bit-equal to the host gather and to the "
        f"CentroidLocatorRegridder where both located a face ({int(both.sum())} cells, {one_only} located by one "
        f"only); rasterize({resolution}): {by_resolution.shape} in {resolution_s:.4f} s, bit-equal [{card}]"
    )

    # 11.5: the nearest fill of (time=4, face) with 10 % NaN in patches,
    # then regridded onto the raster.
    gaps = nan_patches(mesh.centroids, FILL_FRACTION, rng)
    gappy = mesh_data[:FILL_SLICES].copy()
    gappy[:, gaps] = np.nan
    known = ~np.isnan(gappy)
    gappy_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(gappy).to(device), dims=("time", mesh.face_dimension), name="v"), mesh
    )
    t0 = time.perf_counter()
    filled = gappy_uda.ugrid.interpolate_na()
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if filled.data.device != device or filled.data.dtype != torch.float64:
        raise AssertionError(f"interpolate_na: {filled.data.dtype} on {filled.data.device}")
    filled_np = filled.data.cpu().numpy()
    n_equidistant = 0
    for k in range(FILL_SLICES):
        i_source, i_target = np.flatnonzero(known[k]), np.flatnonzero(~known[k])
        sources, queries = mesh.centroids[i_source], mesh.centroids[i_target]
        chosen = nearest.nearest_points(sources, queries)
        n_equidistant += check_nearest(f"interpolate_na slice {k}", sources, queries, chosen, KDTree(sources))[0]
        np.testing.assert_array_equal(filled_np[k, i_target], gappy[k, i_source[chosen]].astype(np.float64))
        np.testing.assert_array_equal(filled_np[k, i_source], gappy[k, i_source].astype(np.float64))
    print(
        f"  11.5 interpolate_na of (time={FILL_SLICES}, face) with {int(gaps.sum())} NaN faces in patches "
        f"({gaps.mean() * 100:.2f} %; {int(known[0].sum())} known): {fill_s:.3f} s; every fill the value of the "
        f"KDTree's nearest known face but {n_equidistant} equidistant; float64 on the card [{card}]"
    )
    regridder = xt.OverlapRegridder(filled, target, method="mean")
    before = {k.__name__: k.launches for k in kernels}
    out = regridder.regrid(filled)
    torch.cuda.synchronize()
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    source = filled.data
    err = check_apply(
        "11.5 the filled data onto the raster (mean)", regridder, source, out.data, window_reduce, rose,
        float(np.nanmax(np.abs(filled_np))),
        lambda got, csr=regridder._weights: (got, reference_linear(csr, filled_np, relative=False)),
    )

    # 11.6: the facet remaps and reindexing.
    for label, obj, values, conn in (
        ("to_node", uda, mesh_data, mesh.format_connectivity_as_dense(mesh.node_face_connectivity)),
        ("to_edge", uda, mesh_data, mesh.edge_face_connectivity),
        ("to_face", node_uda, node_data, mesh.face_node_connectivity),
    ):
        t0 = time.perf_counter()
        mapped = getattr(obj.ugrid, label)()
        torch.cuda.synchronize()
        map_s = time.perf_counter() - t0
        want = np.where(conn >= 0, values[:, np.maximum(conn, 0)], np.nan).astype(values.dtype)
        bit_equal(label, mapped.data, want, device)
        print(f"  11.6 {label}: {tuple(mapped.shape)} in {map_s:.4f} s; bit-equal to numpy's gather [{card}]")
    face_perm = rng.permutation(mesh.n_face)
    node_perm = rng.permutation(mesh.n_node)
    inverse = np.empty_like(node_perm)
    inverse[node_perm] = np.arange(mesh.n_node)
    shuffled = xt.Ugrid2d(verts[node_perm, 0], verts[node_perm, 1], -1, inverse[faces[face_perm]])
    shuffled_uda = xt.UgridDataArray(
        xt.xdata.DataArray(uda.data[:, torch.from_numpy(face_perm).to(device)], dims=uda.dims, name="v"), shuffled
    )
    t0 = time.perf_counter()
    back = shuffled_uda.ugrid.reindex_like(mesh)
    torch.cuda.synchronize()
    reindex_s = time.perf_counter() - t0
    bit_equal("reindex_like", back.data, mesh_data, device)
    print(f"  11.6 reindex_like of a shuffled copy of the mesh: {reindex_s:.3f} s; bit-equal to the original [{card}]")

    # 11.7: phase 7's network.
    network, edge_values = phase7_network()
    edge_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(edge_values).to(device), dims=("time", network.edge_dimension), name="q"),
        network,
    )
    chosen_edges = rng.choice(network.n_edge, size=min(1000, network.n_edge // 2), replace=False)
    a = network.node_coordinates[network.edge_node_connectivity[chosen_edges, 0]]
    b = network.node_coordinates[network.edge_node_connectivity[chosen_edges, 1]]
    on_edges = 0.7 * a + 0.3 * b
    off = rng.uniform(0.0, float(N_SIDE), (10, 2))
    pts = np.concatenate([on_edges, off])
    t0 = time.perf_counter()
    out = edge_uda.ugrid.sel_points(pts[:, 0], pts[:, 1], out_of_bounds="ignore")
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    on_network = network.locate_points(pts)
    if not np.array_equal(on_network[: len(chosen_edges)], chosen_edges) or (on_network[len(chosen_edges):] >= 0).any():
        raise AssertionError("network sel_points: the stations were not located on their edges")
    bit_equal("network sel_points", out.data, host_gather(edge_values, on_network).astype(np.float32), device)
    t0 = time.perf_counter()
    section = edge_uda.ugrid.intersect_line((0.0, 0.5 * N_SIDE + 0.3), (float(N_SIDE), 0.5 * N_SIDE - 0.3))
    torch.cuda.synchronize()
    line_s = time.perf_counter() - t0
    edge_index = section[network.edge_dimension].values
    xy = np.column_stack([section[f"{network.name}_x"].values, section[f"{network.name}_y"].values])
    p, q = (network.node_coordinates[network.edge_node_connectivity[edge_index, i]] for i in (0, 1))
    d = q - p
    t = np.clip(((xy - p) * d).sum(axis=1) / (d * d).sum(axis=1), 0.0, 1.0)
    off_edge = np.linalg.norm(p + t[:, None] * d - xy, axis=1).max()
    if off_edge > 1e-9 or (np.diff(section[f"{network.name}_s"].values) < 0).any():
        raise AssertionError(f"network intersect_line: points {off_edge:.3e} off their edges, or s decreasing")
    bit_equal("network intersect_line", section.data, edge_values[:, edge_index], device)
    node_values = rng.normal(size=(2, network.n_node))
    node_values[:, rng.random(network.n_node) < FILL_FRACTION] = np.nan
    node_fill_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(node_values).to(device), dims=("time", network.node_dimension)), network
    )
    t0 = time.perf_counter()
    node_filled = node_fill_uda.ugrid.interpolate_na()
    torch.cuda.synchronize()
    dijkstra_s = time.perf_counter() - t0
    e = network.edge_node_connectivity
    length = np.linalg.norm(network.node_coordinates[e[:, 1]] - network.node_coordinates[e[:, 0]], axis=1)
    graph = coo_matrix(
        (np.concatenate([length, length]), (np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]]))),
        shape=(network.n_node,) * 2,
    ).tocsr()
    known_nodes = np.flatnonzero(~np.isnan(node_values[0]))
    _, _, nearest_known = dijkstra(graph, indices=known_nodes, min_only=True, return_predecessors=True)
    want = np.where(nearest_known >= 0, node_values[:, np.maximum(nearest_known, 0)], np.nan)
    bit_equal("network interpolate_na", node_filled.data, want, device)
    print(
        f"  11.7 network ({network.n_edge} edges): sel_points of {len(pts)} stations {sel_s:.4f} s, each on its "
        f"edge, bit-equal; intersect_line across it: {len(edge_index)} crossings in {line_s:.4f} s, on their "
        f"edges, s non-decreasing, bit-equal; interpolate_na of (2, node) with "
        f"{int(np.isnan(node_values[0]).sum())} NaN nodes by Dijkstra {dijkstra_s:.3f} s, bit-equal to scipy's "
        f"dijkstra called directly [{card}]"
    )

    counts = {k.__name__: k.launches for k in kernels}
    if counts != {"window_reduce": 1, "window_select": 0, "csr_matvec": 0}:
        raise AssertionError(f"phase 11 launched {counts}")
    return counts, {"window_reduce": err}, timed


MORPH_ITERATIONS, MASK_FRACTION = 5, 0.05


def ring_pairs(faces):
    """Each face's sides as sorted node pairs: (keys a * n + b with a < b
    (n_face, n_side), the node count n)."""
    n = int(faces.max()) + 1
    a, b = faces, np.roll(faces, -1, axis=1)
    return np.minimum(a, b) * n + np.maximum(a, b), n


def shoelace(xy):
    """Signed area of each polygon row (..., k, 2)."""
    x, y = xy[..., 0], xy[..., 1]
    return 0.5 * (x * np.roll(y, -1, axis=-1) - np.roll(x, -1, axis=-1) * y).sum(axis=-1)


def tessellation_ties(label, card_grid, host_grid, nodes):
    """Hold a tessellation whose angle sort ran on the card to the same
    one sorted on the CPU: every array equal, but for rows where two
    vertices lie on the same angle from the row's node (within 1e-12
    rad) and the card's atan2 and numpy's order them apart.  Such a row
    holds the same vertices, in swapped runs, with the same area within
    1e-9 relative.  Returns the count of such rows."""
    for name in ("node_x", "node_y"):
        np.testing.assert_array_equal(getattr(card_grid, name), getattr(host_grid, name), err_msg=f"{label} {name}")
    a, b = card_grid.face_node_connectivity, host_grid.face_node_connectivity
    if a.shape != b.shape:
        raise AssertionError(f"{label}: face_node_connectivity {a.shape} against {b.shape} sorted on the CPU")
    rows = np.flatnonzero((a != b).any(axis=1))
    xy = card_grid.node_coordinates
    for r in rows:
        ra, rb = a[r][a[r] >= 0], b[r][b[r] >= 0]
        if r >= len(nodes) or not np.array_equal(np.sort(ra), np.sort(rb)):
            raise AssertionError(f"{label}: row {r} differs in its vertices from the CPU's")
        area_a, area_b = shoelace(xy[ra]), shoelace(xy[rb])
        if abs(area_a - area_b) > 1e-9 * abs(area_b):
            raise AssertionError(f"{label}: row {r} area {area_a!r} against {area_b!r}")
        angle = np.arctan2(xy[ra, 1] - nodes[r, 1], xy[ra, 0] - nodes[r, 0])
        differ = np.flatnonzero(ra != rb)
        runs = np.split(differ, np.flatnonzero(np.diff(differ) > 1) + 1)
        spread = max(np.ptp(angle[run]) for run in runs)
        if spread > 1e-12:
            raise AssertionError(f"{label}: row {r} ordered apart at angles {spread:.3e} rad apart")
    return len(rows)


def morphology_reference(start, value, iterations, mask, border_value):
    """Independent reference of the accessor's binary dilation (``value``
    True) or erosion on the structured face layout of phase 3's mesh,
    (ny, nx) faces: scipy.ndimage one step at a time with the four-
    neighbour cross (outside the mesh False for a dilation, True for an
    erosion, so it takes no part), ``mask`` set to ``not value`` after
    every step, the boundary faces set to ``value`` after the first step
    where ``border_value`` equals ``value``."""
    from scipy import ndimage

    cross = ndimage.generate_binary_structure(2, 1)
    border = np.zeros_like(start)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    out = start.copy()
    for step in range(max(iterations, 1)):
        if value:
            out = ndimage.binary_dilation(out, cross)
        else:
            out = ndimage.binary_erosion(out, cross, border_value=1)
        if mask is not None:
            out[mask] = not value
        if step == 0 and border_value == value:
            out[border] = value
    return out


def edge_rows(xy):
    """Each edge's end coordinates (n, 2, 2) as one row (x0, y0, x1, y1),
    the lesser end (by x, then y) first: a key that ignores direction."""
    a, b = xy[:, 0], xy[:, 1]
    swap = ((a[:, 0] > b[:, 0]) | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1])))[:, None]
    return np.concatenate([np.where(swap, b, a), np.where(swap, a, b)], axis=1)


def kahn_is_cyclic(n, edges):
    """Independent reference: whether a directed graph holds a cycle
    (Kahn's algorithm: some vertex is never freed of incoming edges)."""
    from collections import deque

    order = np.argsort(edges[:, 0], kind="stable")
    starts = np.searchsorted(edges[order, 0], np.arange(n + 1))
    heads = edges[order, 1]
    indegree = np.bincount(edges[:, 1], minlength=n)
    queue = deque(np.flatnonzero(indegree == 0).tolist())
    seen = 0
    while queue:
        v = queue.popleft()
        seen += 1
        for u in heads[starts[v]:starts[v + 1]].tolist():
            indegree[u] -= 1
            if indegree[u] == 0:
                queue.append(u)
    return seen < n


def phase_topology(device, card, inputs, main_results):
    """Phase 12: the topology operations at the 1M config, through
    ``Ugrid2d``, ``Ugrid1d`` and the ``.ugrid`` accessors with payloads on
    the card, and their results regridded and filled through the three
    kernels: the centroidal dual as an overlap target (window_reduce),
    the connected components of the eroded wet faces by mode
    (window_select), the reordered faces by mean (window_reduce), the
    periodic mesh's Laplace fill (csr_matvec).  Every result is held to a
    host computation written here from the arrays.  Returns (launch
    counts, largest |kernel - plain|)."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain, window_reduce
    from xugrid_tpu_torch.regrid.apply import device_weights
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.ugrid import connectivity, interpolate
    from xugrid_tpu_torch.utils.profiling import timings

    (verts, faces), (tverts, tfaces), mesh_data = inputs
    t_phase = t0 = time.perf_counter()
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    n_edge = mesh.n_edge
    print(
        f"phase 12: topology operations on the 1M mesh ({mesh.n_face} faces, {mesh.n_node} nodes, {n_edge} edges "
        f"derived in {time.perf_counter() - t0:.3f} s), then regrid and fill [{card}]"
    )
    rng = np.random.default_rng(12)
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    max_err = {"window_reduce": 0.0, "window_select": 0.0, "csr_matvec": 0.0}
    scale = float(np.nanmax(np.abs(mesh_data)))
    face_dim, node_dim, edge_dim = mesh.face_dimension, mesh.node_dimension, mesh.edge_dimension

    def timed_call(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 12.1: triangulation, exterior edges and faces, derived geometry.
    tri_grid, tri_s = timed_call(mesh.triangulate)
    ((tri_x, tri_y, triangles), tri_face), triangulation_s = timed_call(lambda: mesh.triangulation)
    fan = np.stack([faces[:, [0, 1, 2]], faces[:, [0, 2, 3]]], axis=1).reshape(-1, 3)
    np.testing.assert_array_equal(tri_grid.face_node_connectivity, fan, err_msg="triangulate: not the fans")
    np.testing.assert_array_equal(triangles, fan)
    np.testing.assert_array_equal(tri_face, np.repeat(np.arange(len(faces)), 2))
    if tri_x is not mesh.node_x or tri_y is not mesh.node_y or mesh.triangulation is not mesh.triangulation:
        raise AssertionError("triangulation: not the grid's node arrays, or not cached")
    face_area = np.abs(shoelace(verts[faces]))
    tri_area = np.bincount(tri_face, weights=np.abs(shoelace(verts[triangles])), minlength=len(faces))
    area_err = float(np.max(np.abs(tri_area - face_area) / face_area))
    if area_err > 1e-12:
        raise AssertionError(f"triangulate: triangle areas off their face's by {area_err:.3e} relative")
    keys, n_key = ring_pairs(faces)
    unique_keys, counts = np.unique(keys, return_counts=True)
    exterior_keys = unique_keys[counts == 1]
    exterior_edges, exterior_s = timed_call(lambda: mesh.exterior_edges)
    exterior_faces = mesh.exterior_faces
    got_keys = np.sort(mesh.edge_node_connectivity[exterior_edges], axis=1)
    got_keys = np.sort(got_keys[:, 0] * n_key + got_keys[:, 1])
    np.testing.assert_array_equal(got_keys, exterior_keys, err_msg="exterior_edges")
    want_faces = np.flatnonzero(np.isin(keys, exterior_keys).any(axis=1))
    np.testing.assert_array_equal(exterior_faces, want_faces, err_msg="exterior_faces")
    if len(exterior_edges) != 4 * N_SIDE or len(exterior_faces) != 4 * N_SIDE - 4:
        raise AssertionError(f"{len(exterior_edges)} exterior edges, {len(exterior_faces)} exterior faces")
    ring = verts[np.concatenate([faces, faces[:, :1]], axis=1)]
    perimeter_want = np.hypot(*np.diff(ring, axis=1).transpose(2, 0, 1)).sum(axis=1)
    perimeter, perimeter_s = timed_call(lambda: mesh.perimeter)
    np.testing.assert_allclose(perimeter, perimeter_want, rtol=1e-12, atol=0.0, err_msg="perimeter")
    corners = verts[faces]
    face_bounds, bounds_s = timed_call(lambda: mesh.face_bounds)
    np.testing.assert_array_equal(face_bounds, np.column_stack([corners.min(axis=1), corners.max(axis=1)]))
    edge_corners = verts[mesh.edge_node_connectivity]
    np.testing.assert_array_equal(mesh.edge_bounds, np.column_stack([edge_corners.min(axis=1), edge_corners.max(axis=1)]))
    np.testing.assert_array_equal(mesh.face_node_coordinates, corners)
    valid, validate_s = timed_call(mesh.validate_edge_node_connectivity)
    if not valid.all() or len(valid) != n_edge:
        raise AssertionError(f"validate_edge_node_connectivity: {int((~valid).sum())} of {len(valid)} invalid")
    shuffled = mesh.edge_node_connectivity[rng.permutation(n_edge)][:, ::-1]
    duplicated = np.concatenate([shuffled, shuffled[:10]])
    checked = connectivity.validate_edge_node_connectivity(faces, duplicated)
    if not checked[:n_edge].all() or checked[n_edge:].any():
        raise AssertionError("validate_edge_node_connectivity: the appended duplicates were not refused")
    print(
        f"  12.1 triangulate(): {tri_grid.n_face} triangles in {tri_s:.3f} s (triangulation {triangulation_s:.3f} s), "
        f"the fans of the faces' first nodes, areas summing to each face's within {area_err:.3e} relative; "
        f"exterior_edges {len(exterior_edges)} ({exterior_s:.3f} s), exterior_faces {len(exterior_faces)}, equal to "
        f"the sides held by one face; perimeter ({perimeter_s:.3f} s) within rtol 1e-12, face_bounds "
        f"({bounds_s:.3f} s), edge_bounds, face_node_coordinates equal; validate_edge_node_connectivity "
        f"{validate_s:.3f} s, all {n_edge} valid, 10 appended duplicates refused [{card}]"
    )

    # 12.2: the centroidal and circumcenter tessellations with the angle
    # sort on the card against the CPU's, then the mesh regridded onto the
    # centroidal dual.
    duals = {}
    for label, grid, method in (
        ("centroidal", mesh, "tesselate_centroidal_voronoi"),
        ("circumcenter (of the triangulation)", tri_grid, "tesselate_circumcenter_voronoi"),
    ):
        # The grid's cached connectivity and centres first, so that both
        # timed calls find them.
        _, cache_s = timed_call(lambda: (
            grid.node_face_connectivity, grid.edge_face_connectivity,
            grid.centroids if grid is mesh else grid.circumcenters,
        ))
        sort_s = {}
        for where in ("card", "cpu"):
            timings.reset()
            if where == "card":
                on_card, card_s = timed_call(getattr(grid, method))
            else:
                on_host, host_s = timed_call(lambda: getattr(grid, method)(device="cpu"))
            sort_s[where] = timings.summary()["voronoi.angle_sort"]["total_s"]
        ties = tessellation_ties(label, on_card, on_host, grid.node_coordinates)
        duals[label] = on_card
        print(
            f"  12.2 {method}: {on_card.n_face} cells, {on_card.n_node} vertices, {on_card.n_max_node_per_face} "
            f"nodes at most; the grid's connectivity and centres {cache_s:.3f} s, then the tessellation "
            f"{card_s:.3f} s with the angle sort on the card (the sort {sort_s['card']:.3f} s), "
            f"{host_s:.3f} s on the CPU (the sort {sort_s['cpu']:.3f} s); equal in every array but {ties} rows of "
            f"angle ties [{card}]"
        )
    dual = duals["centroidal"]
    if dual.n_face != mesh.n_node:
        raise AssertionError(f"centroidal dual: {dual.n_face} cells for {mesh.n_node} nodes")
    source = torch.from_numpy(mesh_data).to(device)
    uda = xt.UgridDataArray(xt.xdata.DataArray(source, dims=("time", face_dim), name="v"), mesh)
    t0 = time.perf_counter()
    regridder = xt.OverlapRegridder(mesh, dual, method="mean")
    build_s = time.perf_counter() - t0
    before = {k.__name__: k.launches for k in kernels}
    out, first_s = timed_call(lambda: regridder.regrid(uda))
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    if out.data.device != device or tuple(out.data.shape) != (N_EXTRA, dual.n_face):
        raise AssertionError(f"regrid onto the dual: {tuple(out.data.shape)} on {out.data.device}")
    err = check_apply(
        "12.2 the mesh onto its centroidal dual (mean)", regridder, source, out.data, window_reduce, rose, scale,
        lambda got, csr=regridder._weights: (got, reference_linear(csr, mesh_data, relative=False)),
    )
    max_err["window_reduce"] = max(max_err["window_reduce"], err)
    print(f"       weights {build_s:.3f} s, first pass {first_s:.4f} s [{card}]")

    # 12.3: dilate and erode the wet faces, take the eroded ones, label
    # their components and regrid the labels by mode.
    side = (N_SIDE, N_SIDE)
    dry = nan_patches(mesh.centroids, FILL_FRACTION, rng)
    wet = ~dry
    mask = nan_patches(mesh.centroids, MASK_FRACTION, rng)
    wet_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(wet).to(device), dims=(face_dim,), name="wet"), mesh
    )
    mask_tensor = torch.from_numpy(mask).to(device)
    mask_uda = xt.UgridDataArray(xt.xdata.DataArray(mask_tensor, dims=(face_dim,)), mesh)
    morphology = {}
    for op, value in (("binary_dilation", True), ("binary_erosion", False)):
        for masked in (False, True):
            for border_value in (False, True):
                given = None if not masked else (mask_tensor if value else mask_uda)
                result, op_s = timed_call(lambda: getattr(wet_uda.ugrid, op)(
                    iterations=MORPH_ITERATIONS, mask=given, border_value=border_value
                ))
                want = morphology_reference(
                    wet.reshape(side), value, MORPH_ITERATIONS, mask.reshape(side) if masked else None, border_value
                ).ravel()
                if not isinstance(result, xt.UgridDataArray) or result.data.dtype != torch.bool:
                    raise AssertionError(f"{op}: {type(result).__name__} {result.data.dtype}")
                bit_equal(f"{op} mask={masked} border_value={border_value}", result.data, want, device)
                morphology[(op, masked, border_value)] = result
                print(
                    f"  12.3 {op}(iterations={MORPH_ITERATIONS}, mask={'a ' + type(given).__name__ if masked else None}, "
                    f"border_value={border_value}): {op_s:.3f} s; {int(want.sum())} True of {len(want)}, bit-equal to "
                    f"scipy.ndimage step by step, a bool tensor on the card [{card}]"
                )
    eroded = morphology[("binary_erosion", False, False)]
    keep = np.flatnonzero(eroded.data.cpu().numpy())
    subset, subset_s = timed_call(lambda: eroded.isel({face_dim: keep}))
    labels, labels_s = timed_call(lambda: subset.ugrid.connected_components())
    if subset.ugrid.grid.n_face != len(keep) or labels.data.device != device:
        raise AssertionError(f"subset {subset.ugrid.grid.n_face} faces, labels on {labels.data.device}")
    kept = np.zeros(side, dtype=bool)
    kept.ravel()[keep] = True
    position = np.full(mesh.n_face, -1)
    position[keep] = np.arange(len(keep))
    grid_index = np.arange(mesh.n_face).reshape(side)
    pairs = [
        (grid_index[:, :-1][kept[:, :-1] & kept[:, 1:]], grid_index[:, 1:][kept[:, :-1] & kept[:, 1:]]),
        (grid_index[:-1][kept[:-1] & kept[1:]], grid_index[1:][kept[:-1] & kept[1:]]),
    ]
    i = position[np.concatenate([p[0] for p in pairs])]
    j = position[np.concatenate([p[1] for p in pairs])]
    adjacency = coo_matrix((np.ones(len(i)), (i, j)), shape=(len(keep), len(keep))).tocsr()
    n_components, want_labels = connected_components(adjacency, directed=False)
    bit_equal("connected_components", labels.data, want_labels, device)
    print(
        f"  12.3 isel of the {len(keep)} eroded wet faces {subset_s:.3f} s; connected_components {labels_s:.3f} s: "
        f"{n_components} components, equal to scipy's of the four-neighbour adjacency, on the card [{card}]"
    )
    label_source = labels.data.to(torch.float32)[None, :]
    label_uda = xt.UgridDataArray(
        xt.xdata.DataArray(label_source, dims=("time", subset.ugrid.grid.face_dimension), name="label"),
        subset.ugrid.grid,
    )
    regridder = xt.OverlapRegridder(subset.ugrid.grid, target, method="mode")
    before = {k.__name__: k.launches for k in kernels}
    out, first_s = timed_call(lambda: regridder.regrid(label_uda))
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    sample = np.sort(rng.choice(target.n_face, size=min(400, target.n_face), replace=False))
    label_np = label_source.cpu().numpy()
    err = check_apply(
        "12.3 the component labels onto the raster (mode)", regridder, label_source, out.data, window_select, rose,
        float(label_np.max()),
        lambda got, csr=regridder._weights: (got[:, sample], reference_select(csr, label_np, sample, "mode")),
    )
    max_err["window_select"] = max(max_err["window_select"], err)

    # 12.4: the faces in reverse Cuthill-McKee order, regridded.
    reordered, rcm_s = timed_call(uda.ugrid.reverse_cuthill_mckee)
    _, order = mesh.reverse_cuthill_mckee()
    if not np.array_equal(np.sort(order), np.arange(mesh.n_face)):
        raise AssertionError("reverse_cuthill_mckee: the order is not a permutation of the faces")
    np.testing.assert_array_equal(reordered.ugrid.grid.face_node_connectivity, faces[order])
    bit_equal("reverse_cuthill_mckee payload", reordered.data, mesh_data[:, order], device)
    ff = mesh.face_face_connectivity.tocoo()
    inverse = np.empty_like(order)
    inverse[order] = np.arange(len(order))
    bandwidth = (int(np.abs(ff.row - ff.col).max()), int(np.abs(inverse[ff.row] - inverse[ff.col]).max()))
    rcm_regridder = xt.OverlapRegridder(reordered.ugrid.grid, target, method="mean")
    before = {k.__name__: k.launches for k in kernels}
    rcm_out, first_s = timed_call(lambda: rcm_regridder.regrid(reordered))
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    rcm_source = reordered.data
    err = check_apply(
        "12.4 the reordered mesh onto the raster (mean)", rcm_regridder, rcm_source, rcm_out.data, window_reduce, rose,
        scale, lambda got, csr=rcm_regridder._weights: (got, reference_linear(csr, mesh_data[:, order], relative=False)),
    )
    max_err["window_reduce"] = max(max_err["window_reduce"], err)
    (_, _, _, mean_regridder, mean_out, *_), = (r for r in main_results if r[1] == "mean")
    rtol, atol = tolerance(torch.float32, scale)
    idx, w = device_weights(rcm_regridder._padded, torch.float32, device, rcm_regridder._device_weights)
    bound = torch.clamp(summation_bound(rcm_source, idx, w, rcm_regridder._reduction), min=atol)
    diff = compare(rcm_out.data, mean_out, False, rtol, bound)
    # How far apart neighbouring raster cells read the source: the step
    # between consecutive cells' lowest source faces.
    steps = []
    for csr in (mean_regridder._weights, rcm_regridder._weights):
        starts = csr.indptr[np.flatnonzero(np.diff(csr.indptr) > 0)]
        steps.append(np.median(np.abs(np.diff(np.minimum.reduceat(csr.indices, starts)))))
    print(
        f"  12.4 reverse_cuthill_mckee: {rcm_s:.3f} s, face adjacency bandwidth {bandwidth[0]} -> {bandwidth[1]}, "
        f"median step between neighbouring raster cells' first source faces {steps[0]:.0f} -> {steps[1]:.0f}; "
        f"payload bit-equal to "
        f"payload[:, order] on the card; the regrid within rtol {rtol} and the float32 summation bound of phase "
        f"3's in the original order, max |diff| {diff:.3e} [{card}]"
    )

    # 12.5: periodic, a Laplace fill across the seam, and back.
    xmax = float(N_SIDE)
    node_values = rng.normal(size=(2, mesh.n_node))
    edge_values = rng.normal(size=n_edge)
    ds = xt.xdata.Dataset()
    ds["face_v"] = (("time", face_dim), source)
    ds["node_v"] = (("layer", node_dim), torch.from_numpy(node_values).to(device))
    ds["edge_v"] = ((edge_dim,), torch.from_numpy(edge_values).to(device))
    uds = xt.UgridDataset(ds, [mesh])
    periodic, periodic_s = timed_call(uds.ugrid.to_periodic)
    pgrid = periodic.ugrid.grid
    right = verts[:, 0] == xmax
    edge_nodes = mesh.edge_node_connectivity
    right_edges = right[edge_nodes].all(axis=1)
    if pgrid.n_node != mesh.n_node - (N_SIDE + 1) or pgrid.n_edge != n_edge - N_SIDE:
        raise AssertionError(f"to_periodic: {pgrid.n_node} nodes, {pgrid.n_edge} edges")
    bit_equal("to_periodic face payload", periodic["face_v"].data, mesh_data, device)
    bit_equal("to_periodic node payload", periodic["node_v"].data, node_values[:, ~right], device)
    bit_equal("to_periodic edge payload", periodic["edge_v"].data, edge_values[~right_edges], device)
    pkeys, pn = ring_pairs(pgrid.face_node_connectivity)
    pkeys = np.unique(pkeys)
    a, b = pkeys // pn, pkeys % pn
    seam = int((np.abs(pgrid.node_x[a] - pgrid.node_x[b]) > 0.5 * xmax).sum())
    W = coo_matrix(
        (np.ones(2 * len(a)), (np.concatenate([a, b]), np.concatenate([b, a]))), shape=(pgrid.n_node,) * 2
    ).tocsr()
    truth, known = laplace_inputs(pgrid.node_coordinates)
    fill_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(known).to(device), dims=(pgrid.node_dimension,), name="h"), pgrid
    )
    before = csr_matvec.launches
    filled, fill_s = timed_call(lambda: fill_uda.ugrid.laplace_interpolate(xy_weights=False, **LAPLACE_SOLVE))
    info = dict(interpolate.last_solve_info)
    launches = csr_matvec.launches - before
    if launches != 1 + (info["degree"] - 1) + info["iterations"] * info["degree"]:
        raise AssertionError(f"periodic fill: {launches} csr_matvec launches for {info['iterations']} iterations")
    if filled.data.device != device or not torch.isfinite(filled.data).all():
        raise AssertionError("periodic fill: not finite, or not on the card")
    residual = unknown_residuals(W, known[None, :], filled.data.cpu().numpy()[None, :])
    if residual.max() > 10 * LAPLACE_SOLVE["atol"]:
        raise AssertionError(f"periodic fill: host residual {residual.max():.3e} > 10 * atol")
    prep = [v for k, v in interpolate._SYSTEMS.items() if k[0] == "laplace"][-1]
    indptr, indices, data64 = (prep["system"][k] for k in ("indptr", "indices", "data"))
    x = torch.from_numpy(rng.normal(size=(indptr.numel() - 1, 1))).to(device)
    path_launches = csr_matvec.launches  # the comparison's launch is no launch of the path
    max_err["csr_matvec"] = compare(
        csr_matvec(indptr, indices, data64, x), csr_matvec_plain(indptr, indices, data64, x), True, 0.0, 0.0
    )
    csr_matvec.launches = path_launches
    back, back_s = timed_call(lambda: periodic.ugrid.to_nonperiodic(xmax=xmax))
    bgrid = back.ugrid.grid
    if bgrid.n_node != mesh.n_node or bgrid.n_edge != n_edge:
        raise AssertionError(f"to_nonperiodic: {bgrid.n_node} nodes, {bgrid.n_edge} edges")
    node_match = connectivity.index_like(bgrid.node_coordinates, verts)
    bit_equal("to_nonperiodic face payload", back["face_v"].data, mesh_data, device)
    left_ids = np.flatnonzero(verts[:, 0] == 0.0)
    right_ids = np.flatnonzero(right)
    partner = np.arange(mesh.n_node)
    partner[right_ids[np.argsort(verts[right_ids, 1])]] = left_ids[np.argsort(verts[left_ids, 1])]
    back_nodes = back["node_v"].data[:, torch.from_numpy(node_match).to(device)]
    bit_equal("to_nonperiodic node payload", back_nodes, node_values[:, partner], device)
    edge_match = connectivity.index_like(
        edge_rows(bgrid.node_coordinates[bgrid.edge_node_connectivity]), edge_rows(verts[edge_nodes])
    )
    edge_partner = np.arange(n_edge)
    left_edges = (verts[edge_nodes, 0] == 0.0).all(axis=1)
    lo = np.flatnonzero(left_edges)[np.argsort(verts[edge_nodes[left_edges]][:, :, 1].min(axis=1))]
    hi = np.flatnonzero(right_edges)[np.argsort(verts[edge_nodes[right_edges]][:, :, 1].min(axis=1))]
    edge_partner[hi] = lo
    back_edges = back["edge_v"].data[torch.from_numpy(edge_match).to(device)]
    bit_equal("to_nonperiodic edge payload", back_edges, edge_values[edge_partner], device)
    print(
        f"  12.5 to_periodic: {periodic_s:.3f} s, {pgrid.n_node} nodes ({N_SIDE + 1} fewer), {pgrid.n_edge} edges "
        f"({N_SIDE} fewer), node, edge and face payloads bit-equal to the survivors' on the card; Laplace fill of "
        f"the periodic nodes ({int(np.isnan(known).sum())} unknown, {seam} seam sides): {fill_s:.3f} s, "
        f"{info['iterations']} iterations, csr_matvec +{launches}, host residual max {residual.max():.3e} (scipy, "
        f"float64); to_nonperiodic(xmax={xmax}): {back_s:.3f} s, node coordinates restored as a set, the face "
        f"payload bit-equal to the original, node and edge payloads bit-equal to it but at x = {xmax}, which "
        f"carries the x = 0 survivor's [{card}]"
    )

    # 12.6: phase 7's network: order, cycles, contraction, refinement.
    network, _ = phase7_network()
    net_edges = network.edge_node_connectivity
    line_nodes = NETWORK_SEGMENTS + 1
    firsts = np.arange(NETWORK_LINES) * line_nodes
    loops = np.column_stack([firsts + NETWORK_SEGMENTS, firsts])
    xy = network.node_coordinates
    cases = [("the network", xy, net_edges), ("the network, each line closed", xy, np.concatenate([net_edges, loops]))]
    for k in range(3):
        line = net_edges[k * NETWORK_SEGMENTS:(k + 1) * NETWORK_SEGMENTS] - k * line_nodes
        line_xy = xy[k * line_nodes:(k + 1) * line_nodes]
        cases += [(f"line {k}", line_xy, line),
                  (f"line {k} closed", line_xy, np.concatenate([line, [[NETWORK_SEGMENTS, 0]]]))]
    for label, node_xy, edges in cases:
        n = len(node_xy)
        net = xt.Ugrid1d(node_xy[:, 0], node_xy[:, 1], -1, edges)
        cyclic, cyclic_s = timed_call(lambda: net.is_cyclic)
        if cyclic != kahn_is_cyclic(n, edges) or cyclic != label.endswith("closed"):
            raise AssertionError(f"is_cyclic of {label}: {cyclic}")
        if cyclic:
            try:
                net.topological_sort_by_dfs()
                raise AssertionError(f"topological_sort_by_dfs of {label} did not raise")
            except ValueError as e:
                if str(e) != "The graph contains at least one cycle":
                    raise
        else:
            order = net.topological_sort_by_dfs()
            position = np.empty(n, dtype=np.int64)
            position[order] = np.arange(n)
            if not (position[edges[:, 0]] < position[edges[:, 1]]).all():
                raise AssertionError(f"topological_sort_by_dfs of {label}: an edge points backward")
        print(f"  12.6 {label}: is_cyclic {cyclic} in {cyclic_s:.4f} s, as Kahn's algorithm finds; "
              f"{'the sort raises the cycle error' if cyclic else 'every edge forward in the order'} [{card}]")
    kept_nodes = (firsts[:, None] + np.arange(0, line_nodes, 10)[None, :]).ravel()
    contracted, contract_s = timed_call(lambda: network.contract_vertices(kept_nodes))
    np.testing.assert_array_equal(contracted.node_coordinates, network.node_coordinates[kept_nodes])
    consecutive = np.column_stack([kept_nodes.reshape(NETWORK_LINES, -1)[:, :-1].ravel(),
                                   kept_nodes.reshape(NETWORK_LINES, -1)[:, 1:].ravel()])
    joined = kept_nodes[contracted.edge_node_connectivity]
    np.testing.assert_array_equal(joined[np.argsort(joined[:, 0], kind="stable")], consecutive)
    n_refine = min(1000, network.n_edge // 2)
    chosen = np.sort(rng.choice(network.n_edge, size=n_refine, replace=False))
    p, q = (network.node_coordinates[net_edges[chosen, k]] for k in (0, 1))
    vertices = 0.7 * p + 0.3 * q
    refined, refine_s = timed_call(lambda: network.refine_by_vertices(vertices))
    np.testing.assert_array_equal(refined.node_coordinates[network.n_node:], vertices)
    np.testing.assert_array_equal(refined.node_coordinates[:network.n_node], network.node_coordinates)
    degree = np.bincount(refined.edge_node_connectivity.ravel(), minlength=refined.n_node)
    if refined.n_edge != network.n_edge + n_refine or (degree[network.n_node:] != 2).any():
        raise AssertionError(f"refine_by_vertices: {refined.n_edge} edges")
    self_loops = rng.choice(network.n_node, size=100, replace=False)
    looped = xt.Ugrid1d(network.node_x, network.node_y, -1,
                        np.concatenate([net_edges, np.column_stack([self_loops, self_loops])]))
    cleaned, clean_s = timed_call(looped.remove_self_loops)
    np.testing.assert_array_equal(cleaned.edge_node_connectivity, net_edges)
    np.testing.assert_array_equal(cleaned.node_coordinates, network.node_coordinates)
    print(
        f"  12.6 contract_vertices onto {len(kept_nodes)} nodes {contract_s:.4f} s: exactly those, each joined to "
        f"the next on its line; refine_by_vertices of {n_refine} vertices {refine_s:.4f} s: exactly those added, each "
        f"splitting its edge; remove_self_loops of 100 added loops {clean_s:.4f} s: the network back [{card}]"
    )

    counts = {k.__name__: k.launches for k in kernels}
    if counts["window_reduce"] != 2 or counts["window_select"] != 1 or counts["csr_matvec"] != launches:
        raise AssertionError(f"phase 12 launched {counts}")
    checks_s = time.perf_counter() - t_phase
    # 12.4's passes back to back, the original and the reordered face
    # order in turns.
    passes = {"original": [], "reordered": []}
    for which in ("original", "reordered", "reordered", "original"):
        if which == "original":
            passes[which].append(cuda_time_ms(lambda: mean_regridder.regrid(source)))
        else:
            passes[which].append(cuda_time_ms(lambda: rcm_regridder.regrid(rcm_source)))
    print(
        f"  12.4 overlap mean pass back to back, two runs each in turns: original face order "
        f"{passes['original'][0]:.6f} / {passes['original'][1]:.6f} ms, reverse Cuthill-McKee order "
        f"{passes['reordered'][0]:.6f} / {passes['reordered'][1]:.6f} ms [{card}]"
    )
    print(f"phase 12: {checks_s:.1f} s to the launch counts, {time.perf_counter() - t_phase:.1f} s in all [{card}]")
    return counts, max_err


PAYLOAD_FACES_FRAME = 10_000


def f32_summation(label, got, want, magnitude, terms):
    """A float32 result on the card against its float64 host value: within
    ``terms`` * 2^-24 * ``magnitude`` (the same sum of |x|) plus one
    float32 rounding of the result, NaN where NaN.  Returns the largest
    |diff|."""
    import torch

    bound = torch.from_numpy(terms * 2.0**-24 * np.asarray(magnitude, dtype=np.float64))
    bound = bound + 2.0**-24 * torch.from_numpy(np.abs(want))
    try:
        return compare(got, torch.from_numpy(want), False, 0.0, torch.nan_to_num(bound, nan=0.0))
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None


def host_nanquantile(x, q):
    """numpy's linear nanquantile along axis 0, vectorised over the other
    axis (numpy's own loops over it when NaN are present): the sorted
    column (NaN last) read between the floor and the ceiling of q *
    (count - 1), NaN where the column has no value.  (len(q), n)."""
    ordered = np.sort(x, axis=0)
    count = (~np.isnan(x)).sum(axis=0)
    out = []
    for quantile in q:
        virtual = quantile * np.maximum(count - 1, 0)
        lo = np.floor(virtual).astype(np.int64)
        hi = np.minimum(lo + 1, np.maximum(count - 1, 0))
        a = np.take_along_axis(ordered, lo[None], axis=0)[0]
        b = np.take_along_axis(ordered, hi[None], axis=0)[0]
        out.append(np.where(count > 0, a + (b - a) * (virtual - lo), np.nan))
    return np.stack(out)


def component_residuals(W, values, filled, labels):
    """Per connected component, the norm of the residual of its unknown
    system (D - W)_uu x_u - W_uk x_k, in float64 with scipy on the host
    (``unknown_residuals`` by component).  ``values`` (n,) holds NaN at
    the unknowns."""
    import scipy.sparse

    unknown = np.isnan(values)
    W = W.tocsr()
    L = scipy.sparse.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    r = L[unknown][:, unknown] @ filled[unknown] - W[unknown][:, ~unknown] @ values[~unknown]
    return np.sqrt(np.bincount(labels[unknown], weights=r * r, minlength=labels.max() + 1))


def phase_payload(device, card, inputs, main_results):
    """Phase 13: the payload methods of labelled arrays at the 1M config
    on the card, then their results regridded and a network filled.  A
    (time=20, face) float32 UgridDataset of two variables with 1 % NaN on
    phase 3's mesh: Dataset reductions over time, DataArray methods along
    time, each result a tensor on the card held to a host numpy, scipy or
    pandas reference computed here; the time-mean regridded by phase 3's
    overlap mean (window_reduce) and the quantile stack by its median
    (window_select), each held to the plain version and the host
    reference, and the mean again through ``from_weights(r.weights)``
    (bit-equal); phase 7's network filled through
    ``.ugrid.laplace_interpolate`` (csr_matvec).  Returns (launch counts,
    largest |kernel - plain|)."""
    import pandas as pd
    import scipy.sparse.csgraph
    import torch
    from scipy.stats import rankdata

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.ugrid import interpolate

    (verts, faces), _, _ = inputs
    regridders = {method: regridder for _, method, _, regridder, *_ in main_results}
    t_phase = time.perf_counter()
    mesh = regridders["mean"]._source.ugrid_topology
    face_dim = mesh.face_dimension
    rng = np.random.default_rng(13)
    n_face = mesh.n_face
    h = rng.normal(size=(N_EXTRA, n_face)).astype(np.float32)
    v = (np.round(rng.normal(size=(N_EXTRA, n_face)) * 2.0) / 2.0).astype(np.float32)  # ties
    for x in (h, v):
        x[rng.random(x.shape) < 0.01] = np.nan
    time_coord = np.cumsum(rng.uniform(0.5, 1.5, N_EXTRA))  # uneven, increasing (days)
    ds = xt.xdata.Dataset(
        {"h": (("time", face_dim), torch.from_numpy(h).to(device)), "v": (("time", face_dim), torch.from_numpy(v).to(device))},
        coords={"time": ("time", time_coord)},
    )
    uds = xt.UgridDataset(ds, [mesh])
    torch.cuda.synchronize()
    print(
        f"phase 13: payload methods of a (time={N_EXTRA}, face={n_face}) float32 UgridDataset of two variables "
        f"(1 % NaN, {h.nbytes / 1e6:.0f} MB each) on the card, then regrid and fill [{card}]"
    )
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    max_err = {"window_reduce": 0.0, "window_select": 0.0, "csr_matvec": 0.0}
    scale = float(np.nanmax(np.abs(h)))
    h64 = h.astype(np.float64)

    def report(line):
        print(f"  {line} [{card}]")

    def on_card(label, obj):
        """The payload of a result: a tensor on the card."""
        data = obj.obj.data if isinstance(obj, (xt.UgridDataArray, xt.UgridDataset)) else obj.data
        if not isinstance(data, torch.Tensor) or data.device != device:
            raise AssertionError(f"{label}: the result is not a tensor on {device}")
        return data

    def wall_s(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    host_s = [0.0]

    def host(fn):
        """A host reference, its seconds counted apart."""
        t0 = time.perf_counter()
        value = fn()
        host_s[0] += time.perf_counter() - t0
        return value

    # 13.2: Dataset reductions over time.
    h_abs = host(lambda: np.nanmean(np.abs(h64), axis=0))
    mean_ref = host(lambda: np.nanmean(h64, axis=0))
    std_ref = host(lambda: np.nanstd(h64, axis=0))
    median_ref = host(lambda: np.nanmedian(h64, axis=0))
    quantile_ref = host(lambda: host_nanquantile(h64, [0.1, 0.9]))
    count_ref = (~np.isnan(h)).sum(axis=0)
    reductions = {
        "mean": lambda: uds.mean("time"),
        "std": lambda: uds.std("time"),
        "median": lambda: uds.median("time"),
        "quantile([0.1, 0.9])": lambda: uds.quantile([0.1, 0.9], "time"),
        "count": lambda: uds.count("time"),
    }
    out = {name: fn() for name, fn in reductions.items()}
    for name, result in out.items():
        if not isinstance(result, xt.UgridDataset) or "time" in result.obj.dims:
            raise AssertionError(f"Dataset.{name}: {type(result).__name__} over {result.obj.dims}")
        for var in ("h", "v"):
            on_card(f"Dataset.{name} {var}", result[var])
    mean = on_card("mean", out["mean"]["h"])
    f32_summation("Dataset.mean", mean, mean_ref, h_abs, N_EXTRA)
    compare(on_card("std", out["std"]["h"]), torch.from_numpy(std_ref), False, *tolerance(torch.float32, scale))
    compare(on_card("median", out["median"]["h"]), torch.from_numpy(median_ref), False, 1e-6, 1e-7 * scale)
    quantile = on_card("quantile", out["quantile([0.1, 0.9])"]["h"])
    if quantile.dtype != torch.float64 or out["quantile([0.1, 0.9])"].obj["h"].dims != ("quantile", face_dim):
        raise AssertionError(f"quantile: {quantile.dtype} {out['quantile([0.1, 0.9])'].obj['h'].dims}")
    compare(quantile, torch.from_numpy(quantile_ref), False, 1e-12, 1e-12 * scale)
    count = on_card("count", out["count"]["h"])
    bit_equal("Dataset.count", count, count_ref.astype(np.int64), device)
    bit_equal("Dataset.count v", on_card("count v", out["count"]["v"]), (~np.isnan(v)).sum(axis=0).astype(np.int64), device)
    times = {name: card_ms(fn) for name, fn in reductions.items()}
    report(
        "13.2 Dataset reductions over time, both variables, each within its host reference (numpy float64: mean "
        "within the float32 summation bound, std rtol 1e-5, median rtol 1e-6, quantile float64 rtol 1e-12, count "
        "bit-equal): " + ", ".join(f"{k} {t:.3f} ms" for k, t in times.items())
    )

    # 13.3: DataArray methods along time.
    uda = uds["h"]
    vda = uds["v"]
    if not isinstance(uda, xt.UgridDataArray):
        raise AssertionError(f"uds['h'] is a {type(uda).__name__}")
    timed_ops = {}

    def check(label, fn, want, tol=None, host=False):
        """A method's result on the card, bit-equal to ``want`` (or held by
        ``tol``), and its time: CUDA events, or the first call's wall
        seconds for ``host``-bound ones."""
        result, first_s = wall_s(fn)
        got = on_card(label, result)
        if tol is None:
            bit_equal(label, got, want, device)
        else:
            tol(label, got, want)
        timed_ops[label] = ("s", first_s) if host else ("ms", card_ms(fn))
        return result

    cum_abs = np.cumsum(np.nan_to_num(np.abs(h64)), axis=0)
    check("cumsum", lambda: uda.cumsum("time"), host(lambda: np.cumsum(h64, axis=0)),
          tol=lambda label, got, want: f32_summation(label, got, want, cum_abs, N_EXTRA))
    check("diff", lambda: uda.diff("time"), np.diff(h, axis=0))
    shifted = np.full_like(h, np.nan)
    shifted[3:] = h[:-3]
    check("shift(time=3)", lambda: uda.shift(time=3), shifted)
    check("roll(time=-2)", lambda: uda.roll(time=-2), np.roll(h, -2, axis=0))
    frame = pd.DataFrame(h64)
    check("ffill(limit=2)", lambda: uda.ffill("time", limit=2), host(lambda: frame.ffill(axis=0, limit=2).to_numpy()))
    check("bfill(limit=2)", lambda: uda.bfill("time", limit=2), host(lambda: frame.bfill(axis=0, limit=2).to_numpy()))
    interpolated = check("interpolate_na", lambda: uda.interpolate_na("time"), None, tol=lambda *a: None)
    got = interpolated.obj.data.cpu().numpy()
    rows = np.flatnonzero(np.isnan(h).any(axis=0))
    sample = np.sort(rng.choice(rows, size=min(5000, len(rows)), replace=False))
    interp_ref = h64[:, sample].copy()
    t0 = time.perf_counter()
    for col in range(len(sample)):
        y = interp_ref[:, col]
        ok = ~np.isnan(y)
        if ok.any():
            y[~ok] = np.interp(time_coord[~ok], time_coord[ok], y[ok], left=np.nan, right=np.nan)
    host_s[0] += time.perf_counter() - t0
    compare(torch.from_numpy(got[:, sample]), torch.from_numpy(interp_ref), False, 1e-12, 1e-12 * scale)
    np.testing.assert_array_equal(got[~np.isnan(h64)], h64[~np.isnan(h64)])
    rank_ref = host(lambda: rankdata(v.astype(np.float64), method="average", axis=0, nan_policy="omit"))
    ranked = check("rank", lambda: vda.rank("time"), np.where(np.isnan(v), np.nan, rank_ref))
    v_clean = np.where(np.isnan(v), -np.inf, v)
    idx_ref = time_coord[np.argmax(v_clean, axis=0)]
    idx_ref = np.where(np.isnan(v).all(axis=0), np.nan, idx_ref)
    check("idxmax", lambda: vda.idxmax("time"), idx_ref)
    check("clip(-1, 1.5)", lambda: uda.clip(-1.0, 1.5), np.clip(h, -1.0, 1.5))
    def within_ulp(label, got, want):
        got = got.cpu().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=label)
        np.testing.assert_array_max_ulp(got[~np.isnan(want)], want[~np.isnan(want)], maxulp=1)

    check("round(1)", lambda: uda.round(1), np.round(h, 1), tol=within_ulp)
    check("isin", lambda: vda.isin([0.0, 0.5, 0.1, 2.0]), np.isin(v, np.array([0.0, 0.5, 0.1, 2.0])))
    wet = uds["v"].isel(time=0) > 1.5
    wet_faces = np.flatnonzero(v[0] > 1.5)
    dropped = check("where(drop=True)", lambda: uda.where(wet, drop=True), np.where(v[0] > 1.5, h, np.nan)[:, wet_faces],
                    host=True)
    if dropped.grid.n_face != len(wet_faces):
        raise AssertionError(f"where(drop=True): {dropped.grid.n_face} faces, expected {len(wet_faces)}")
    np.testing.assert_array_equal(dropped.obj[face_dim].values, wet_faces)
    check("fillna(0)", lambda: uda.fillna(0.0), np.where(np.isnan(h), np.float32(0.0), h))
    order = np.argsort(-time_coord, kind="stable")
    check("sortby(time, descending)", lambda: uda.sortby("time", ascending=False), h[order], host=True)
    labels = np.concatenate([time_coord[[5, 0, 19]], [time_coord[3] + 0.25]])
    reindex_ref = np.concatenate([h[[5, 0, 19]], np.full((1, n_face), np.nan, dtype=np.float32)])
    check("reindex(time)", lambda: uda.reindex(time=labels), reindex_ref, host=True)
    weights = rng.uniform(0.0, 1.0, N_EXTRA).astype(np.float32)
    wda = xt.xdata.DataArray(torch.from_numpy(weights).to(device), dims=("time",), name="w")
    h_zero = np.nan_to_num(h64)
    dot_ref = weights.astype(np.float64) @ h_zero
    filled = uda.fillna(0.0)
    # Allow TF32 globally: the product must still be IEEE float32.
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        check("dot(w)", lambda: filled.dot(wda), dot_ref,
              tol=lambda label, got, want: f32_summation(label, got, want, weights @ np.abs(h_zero), N_EXTRA))
    finally:
        torch.set_float32_matmul_precision(previous)
    subset = np.sort(rng.choice(n_face, size=PAYLOAD_FACES_FRAME, replace=False))
    frame_out, frame_s = wall_s(lambda: uds.isel({face_dim: subset}).to_dataframe())
    want_h = h[:, subset].T.ravel() if frame_out.index.names[0] == face_dim else h[:, subset].ravel()
    if len(frame_out) != N_EXTRA * PAYLOAD_FACES_FRAME or list(frame_out.columns) != ["h", "v"]:
        raise AssertionError(f"to_dataframe: {frame_out.shape}, columns {list(frame_out.columns)}")
    np.testing.assert_array_equal(frame_out["h"].to_numpy(), want_h)
    timed_ops["to_dataframe (10,000 faces)"] = ("s", frame_s)
    report(
        "13.3 DataArray methods along time, each result a tensor on the card; cumsum and dot (TF32 allowed "
        "globally, IEEE float32 kept) within the float32 summation bound of float64 host values, interpolate_na "
        "within float64 rtol 1e-12 of np.interp on 5,000 gappy faces, round(1) within 1 ulp of numpy, the rest "
        "bit-equal to numpy, scipy's rankdata and pandas' ffill/bfill: "
        + ", ".join(f"{k} {t:.3f} {unit}" for k, (unit, t) in timed_ops.items())
    )
    if ranked.obj.data.dtype != torch.float64:
        raise AssertionError(f"rank: {ranked.obj.data.dtype}")

    # 13.5-13.6: the results regridded, and the weights round trip.
    mean_regridder, median_regridder = regridders["mean"], regridders["median"]
    time_mean = out["mean"]["h"]
    stack = out["quantile([0.1, 0.9])"]["h"]
    csr = mean_regridder._weights
    before = {k.__name__: k.launches for k in kernels}
    regridded = mean_regridder.regrid(time_mean)
    torch.cuda.synchronize()
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    source = time_mean.obj.data.reshape(1, -1)
    max_err["window_reduce"] = check_apply(
        "13.5 time-mean -> 512 x 512 by overlap mean", mean_regridder, source, regridded.obj.data.reshape(1, -1),
        window_reduce, rose, scale, lambda got: (got, reference_linear(csr, source.cpu().numpy(), relative=False)),
    )
    targets = np.sort(rng.choice(csr.n, size=400, replace=False))
    before = {k.__name__: k.launches for k in kernels}
    stacked = median_regridder.regrid(stack)
    torch.cuda.synchronize()
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    if stacked.obj.dims != ("quantile", stacked.grid.face_dimension) or stacked.obj.data.dtype != torch.float64:
        raise AssertionError(f"median regrid of the quantiles: {stacked.obj.dims} {stacked.obj.data.dtype}")
    max_err["window_select"] = check_apply(
        "13.5 quantile stack (2, face) -> 512 x 512 by overlap median", median_regridder, stack.obj.data,
        stacked.obj.data, window_select, rose, scale,
        lambda got: (got[:, targets], reference_select(median_regridder._weights, stack.obj.data.cpu().numpy(), targets, "median")),
    )
    weights_ds, weights_s = wall_s(lambda: mean_regridder.weights)
    target = regridders["mean"]._target.ugrid_topology
    reloaded, reload_s = wall_s(lambda: xt.OverlapRegridder.from_weights(weights_ds, target, method="mean"))
    before = window_reduce.launches
    again = reloaded.regrid(time_mean)
    torch.cuda.synchronize()
    if window_reduce.launches != before + 1:
        raise AssertionError("weights round trip: not one window_reduce launch")
    bit_equal("weights round trip", again.obj.data, regridded.obj.data.cpu().numpy(), device)
    try:
        mean_regridder.weights = weights_ds
        raise AssertionError("the weights setter took a dataset")
    except TypeError:
        pass
    path_launches = {k: k.launches for k in kernels}  # the timing passes are no launches of the path
    regrid_ms = {
        "time-mean by mean": card_ms(lambda: mean_regridder.regrid(time_mean)),
        "quantile stack by median": card_ms(lambda: median_regridder.regrid(stack)),
    }
    for k, n in path_launches.items():
        k.launches = n
    report(
        f"13.6 weights round trip: .weights {weights_s:.3f} s, from_weights {reload_s:.3f} s, its regrid one "
        f"window_reduce launch bit-equal to the original's; the setter refuses a dataset; regrid passes "
        + ", ".join(f"{k} {t:.3f} ms" for k, t in regrid_ms.items())
    )

    # 13.7: the network Laplace fill.
    network, _ = phase7_network()
    node_dim = network.node_dimension
    truth, known = laplace_inputs(network.node_coordinates)
    line_nodes = NETWORK_SEGMENTS + 1
    known[:line_nodes] = np.nan  # line 0: a component with no known node
    fill_uda = xt.UgridDataArray(
        xt.xdata.DataArray(torch.from_numpy(known).to(device), dims=(node_dim,), name="h"), network
    )
    before = csr_matvec.launches
    filled_net, fill_s = wall_s(lambda: fill_uda.ugrid.laplace_interpolate(**LAPLACE_SOLVE))
    info = dict(interpolate.last_solve_info)
    launches = csr_matvec.launches - before
    if launches != 1 + (info["degree"] - 1) + info["iterations"] * info["degree"]:
        raise AssertionError(f"network fill: {launches} csr_matvec launches for {info['iterations']} iterations")
    got = on_card("network fill", filled_net).cpu().numpy()
    W = network.get_connectivity_matrix(node_dim, xy_weights=True)
    n_comp, comp = scipy.sparse.csgraph.connected_components(W)
    has_known = np.bincount(comp, weights=(~np.isnan(known)).astype(np.float64), minlength=n_comp) > 0
    empty = ~has_known[comp]
    if not np.isnan(got[empty]).all() or not np.isfinite(got[~empty]).all() or not empty[:line_nodes].all():
        raise AssertionError("network fill: components without a known node must stay NaN, the rest finite")
    np.testing.assert_array_equal(got[~np.isnan(known)], known[~np.isnan(known)])
    residual = component_residuals(W, np.where(empty, 0.0, known), np.where(empty, 0.0, got), comp)
    if residual[has_known].max() > 10 * LAPLACE_SOLVE["atol"]:
        raise AssertionError(f"network fill: component residual {residual[has_known].max():.3e} > 10 * atol")
    prep = [v for k, v in interpolate._SYSTEMS.items() if k[0] == "laplace"][-1]
    indptr, indices, data64 = (prep["system"][k] for k in ("indptr", "indices", "data"))
    x = torch.from_numpy(rng.normal(size=(indptr.numel() - 1, 1))).to(device)
    path_launches = csr_matvec.launches  # the comparison's launch is no launch of the path
    max_err["csr_matvec"] = compare(
        csr_matvec(indptr, indices, data64, x), csr_matvec_plain(indptr, indices, data64, x), True, 0.0, 0.0
    )
    csr_matvec.launches = path_launches
    report(
        f"13.7 network Laplace fill of {network.n_node} nodes ({n_comp} lines, {int(has_known.sum())} with a known "
        f"node, 2 % known): {fill_s:.3f} s, {info['iterations']} iterations at degree {info['degree']}, csr_matvec "
        f"+{launches} (the formula's), the line without a known node NaN, every other component's host residual "
        f"at most {residual[has_known].max():.3e} (scipy, float64), csr_matvec bit-equal to its plain version"
    )

    counts = {k.__name__: k.launches for k in kernels}
    if counts["window_reduce"] != 2 or counts["window_select"] != 1 or counts["csr_matvec"] != launches:
        raise AssertionError(f"phase 13 launched {counts}")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s, {host_s[0]:.1f} s of it host references [{card}]")
    return counts, max_err, uds


VECTOR_FACES_FRAME = 10_000
SNAP_NODE_COPIES = 10_000


def geometry_modules():
    """shapely and geopandas: the real packages where importable, else the
    numpy stand-ins of ``tests/fake_geo.py`` placed in ``sys.modules``
    (their ``linestrings`` given shapely's (n, m, 2) form: one linestring
    per row).  Returns (shapely, geopandas, a line saying which)."""
    try:
        import geopandas
        import shapely

        return shapely, geopandas, f"shapely {shapely.__version__} and geopandas {geopandas.__version__}"
    except ImportError:
        pass
    from tests.fake_geo import _make_geopandas_module, _make_shapely_module

    shp, gpd = _make_shapely_module(), _make_geopandas_module()
    flat = shp.linestrings

    def linestrings(xy, y=None, indices=None):
        xy = np.asarray(xy)
        if y is None and indices is None and xy.ndim == 3:
            return flat(xy.reshape(-1, 2), indices=np.repeat(np.arange(len(xy)), xy.shape[1]))
        return flat(xy, y, indices)

    shp.linestrings = linestrings
    sys.modules["shapely"], sys.modules["geopandas"] = shp, gpd
    return shp, gpd, (
        "shapely and geopandas are not installed: the numpy stand-ins of tests/fake_geo.py placed in sys.modules "
        "(linestrings of an (n, m, 2) array one per row, as shapely's)"
    )


def even_odd(points, rings):
    """Even-odd ray cast of (k, 2) points against closed rings (each (n, 2),
    the last vertex joined to the first): True inside."""
    px, py = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), dtype=bool)
    for ring in rings:
        for (ax, ay), (bx, by) in zip(ring, np.roll(ring, -1, axis=0)):
            if ay == by:
                continue
            straddle = (ay > py) != (by > py)
            inside ^= straddle & (px < ax + (py - ay) * (bx - ax) / (by - ay))
    return inside


def ring_distance(points, rings):
    """The least distance of each (k, 2) point to the rings' edges."""
    best = np.full(len(points), np.inf)
    for ring in rings:
        a, b = ring, np.roll(ring, -1, axis=0)
        for (ax, ay), (bx, by) in zip(a, b):
            dx, dy = bx - ax, by - ay
            t = np.clip(((points[:, 0] - ax) * dx + (points[:, 1] - ay) * dy) / (dx * dx + dy * dy), 0.0, 1.0)
            best = np.minimum(best, np.hypot(points[:, 0] - ax - t * dx, points[:, 1] - ay - t * dy))
    return best


def polyline_distance(points, line):
    """The least distance of each (k, 2) point to an open (n, 2) polyline."""
    best = np.full(len(points), np.inf)
    for (ax, ay), (bx, by) in zip(line[:-1], line[1:]):
        dx, dy = bx - ax, by - ay
        length2 = dx * dx + dy * dy
        t = np.clip(((points[:, 0] - ax) * dx + (points[:, 1] - ay) * dy) / length2, 0.0, 1.0) if length2 else 0.0
        best = np.minimum(best, np.hypot(points[:, 0] - ax - t * dx, points[:, 1] - ay - t * dy))
    return best


def segment_crosses_polygon(p, q, poly):
    """Whether the segment p -> q (each (2,)) meets each closed polygon of
    ``poly`` (k, n, 2): an end inside, or a crossing or touch of a side."""
    inside = np.zeros(len(poly), dtype=bool)
    a, b = poly, np.roll(poly, -1, axis=1)

    def cross(o, u, v):
        return (u[..., 0] - o[..., 0]) * (v[..., 1] - o[..., 1]) - (u[..., 1] - o[..., 1]) * (v[..., 0] - o[..., 0])

    for end in (p, q):
        ey = end[1]
        straddle = (a[..., 1] > ey) != (b[..., 1] > ey)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = a[..., 0] + (ey - a[..., 1]) * (b[..., 0] - a[..., 0]) / (b[..., 1] - a[..., 1])
        inside |= (np.sum(straddle & (end[0] < xint), axis=1) % 2) == 1
    P, Q = p[None, None, :], q[None, None, :]
    d1, d2 = cross(P, Q, a), cross(P, Q, b)
    d3, d4 = cross(a, b, P), cross(a, b, Q)
    meets = (d1 * d2 <= 0.0) & (d3 * d4 <= 0.0)
    return inside | meets.any(axis=1)


def region_rings(grid, region, n_region):
    """Per region of faces (``region`` (n_face,), -1 for none): whether a
    node of its boundary is shared by more than two of its boundary edges
    (a pinch), the area of its outer boundary loop and the summed area of
    its inner loops (holes), from the mesh's edges oriented with the
    region on their left."""
    import scipy.sparse
    import scipy.sparse.csgraph

    ef = grid.edge_face_connectivity
    en = grid.edge_node_connectivity
    xy = grid.node_coordinates
    centroids = grid.centroids
    side = np.where(ef >= 0, region[np.maximum(ef, 0)], -1)
    if side.shape[1] == 1:
        side = np.column_stack([side, np.full(len(side), -1)])
        ef = np.column_stack([ef, np.full(len(ef), -1)])
    pairs_r, pairs_e, pairs_f = [], [], []
    for s, o in ((0, 1), (1, 0)):
        keep = (side[:, s] >= 0) & (side[:, s] != side[:, o])
        pairs_r.append(side[keep, s])
        pairs_e.append(np.flatnonzero(keep))
        pairs_f.append(ef[keep, s])
    r, e, f = (np.concatenate(a) for a in (pairs_r, pairs_e, pairs_f))
    n0, n1 = en[e, 0], en[e, 1]
    a, b, c = xy[n0], xy[n1], centroids[f]
    left = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]) > 0.0
    n0, n1 = np.where(left, n0, n1), np.where(left, n1, n0)
    a, b = xy[n0], xy[n1]
    contribution = 0.5 * (a[:, 0] * b[:, 1] - b[:, 0] * a[:, 1])
    keys, inverse = np.unique(np.concatenate([r * grid.n_node + n0, r * grid.n_node + n1]), return_inverse=True)
    degree = np.bincount(inverse, minlength=len(keys))
    pinch = np.zeros(n_region, dtype=bool)
    pinch[keys[degree > 2] // grid.n_node] = True
    k = len(r)
    graph = scipy.sparse.coo_matrix((np.ones(k), (inverse[:k], inverse[k:])), shape=(len(keys), len(keys)))
    _, loop_of_key = scipy.sparse.csgraph.connected_components(graph, directed=False)
    loop = loop_of_key[inverse[:k]]
    loop_area = np.bincount(loop, weights=contribution)
    loop_region = np.zeros(loop.max() + 1, dtype=np.int64)
    loop_region[loop] = r
    outer = np.full(n_region, -np.inf)
    np.maximum.at(outer, loop_region, loop_area)
    holes = np.bincount(loop_region, weights=np.where(loop_area < 0.0, -loop_area, 0.0), minlength=n_region)
    return pinch, outer, holes


def phase_vector(device, card, inputs, main_results, payload):
    """Phase 14: vector geometry and the sample data at the 1M config.
    The stand-in provinces (12 rings of 24 vertices, mapped onto the mesh
    by one affine map keeping the aspect ratio) and a 13th polygon with a
    hole, the hydamo channels (9 lines) and gauges (18 points, mapped by
    the affine map of the channels' bounding box) burned onto phase 3's
    mesh and held to an even-odd ray cast, point containment and segment
    crossings computed here; the burned ids regridded by phase 3's mode
    (window_select) and a burned depth by its mean (window_reduce), each
    held to the plain version and the host references; the ids
    polygonized and held to scipy's components and the mesh's boundary
    loops; the provinces' earcut mesh regridded onto the 1M mesh by mode
    (window_select); the channels snapped to the mesh edges, made a
    Ugrid1d and the gauges filled along it through
    ``.ugrid.laplace_interpolate`` (csr_matvec); 10,000 faces of phase
    13's payload to a GeoDataFrame and back, the mesh's bounding polygon,
    and ``snap_nodes`` of jittered node copies.  Returns (launch counts,
    largest |kernel - plain|)."""
    import scipy.sparse
    import scipy.sparse.csgraph
    import torch
    from scipy.spatial import cKDTree

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.ops.earcut import earcut_triangulate
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, csr_matvec_plain, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.ugrid import interpolate
    from xugrid_tpu_torch.utils.profiling import timings

    t_phase = time.perf_counter()
    shp, gpd, which = geometry_modules()
    print(f"phase 14: vector geometry and sample data at the 1M config, then regrid and fill [{card}]")
    print(f"  {which}")
    regridders = {method: regridder for _, method, _, regridder, *_ in main_results}
    mesh = regridders["mean"]._source.ugrid_topology
    n_face, face_dim = mesh.n_face, mesh.face_dimension
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    max_err = {"window_reduce": 0.0, "window_select": 0.0, "csr_matvec": 0.0}
    step_s = {}
    host_s = [0.0]

    def report(line):
        print(f"  {line} [{card}]")

    def wall(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        step_s[label] = time.perf_counter() - t0
        return out

    def host(fn):
        t0 = time.perf_counter()
        value = fn()
        host_s[0] += time.perf_counter() - t0
        return value

    # 14.1: the inputs.
    provinces = xt.data.provinces_nl()
    scale = float(N_SIDE) / 300e3  # the stand-in's 250 x 300 km domain onto the mesh, aspect kept
    rings = [shp.get_coordinates(p.exterior)[:-1] * scale for p in provinces.geometry]
    # East of the provinces and clear of the channels.
    centre, outer_r, inner_r = np.array([0.9, 0.88]) * N_SIDE, 0.07 * N_SIDE, 0.03 * N_SIDE
    angle = np.linspace(0.0, 2.0 * np.pi, 24, endpoint=False)
    annulus = [centre + outer_r * np.column_stack([np.cos(angle), np.sin(angle)]),
               centre + inner_r * np.column_stack([np.cos(angle), np.sin(angle)])[::-1]]
    polygon_rings = [[r] for r in rings] + [annulus]
    n_poly = len(polygon_rings)
    objects, gauges, _ = xt.data.hydamo_network()
    line_xy = [shp.get_coordinates(g) for g in objects.geometry]
    lo = np.min([xy.min(axis=0) for xy in line_xy], axis=0)
    hi = np.max([xy.max(axis=0) for xy in line_xy], axis=0)

    def channel_map(xy):
        return (xy - lo) / (hi - lo) * (0.9 * N_SIDE) + 0.05 * N_SIDE

    lines = [channel_map(xy) for xy in line_xy]
    points = channel_map(shp.get_coordinates(gauges.geometry))
    n_line, n_point = len(lines), len(points)
    ids = np.arange(n_poly + n_line + n_point, dtype=np.float64)
    rng = np.random.default_rng(14)
    depth = np.round(rng.uniform(0.5, 9.5, len(ids)), 3)
    geometry = ([shp.Polygon(r[0], r[1:]) for r in polygon_rings] + [shp.LineString(xy) for xy in lines]
                + [shp.Point(xy) for xy in points])
    gdf = gpd.GeoDataFrame({"id": ids, "depth": depth}, geometry=geometry)
    report(
        f"14.1 {n_poly - 1} provinces (24-vertex rings, radii {min(np.hypot(*(r - r.mean(0)).T).min() for r in rings):.1f}-"
        f"{max(np.hypot(*(r - r.mean(0)).T).max() for r in rings):.1f} faces) and a ring with a hole, {n_line} channels "
        f"of {sum(len(x) for x in lines)} vertices, {n_point} gauges, mapped onto [0, {N_SIDE}]^2"
    )

    # 14.2: the burns.
    timings.reset()
    burned = wall("burn (all_touched=False)", lambda: xt.burn_vector_geometry(gdf, mesh, column="id"))
    stages = timings.summary()
    touched = wall("burn (all_touched=True)", lambda: xt.burn_vector_geometry(gdf, mesh, column="id", all_touched=True))
    depth_burn = wall("burn of depth", lambda: xt.burn_vector_geometry(gdf, mesh, column="depth"))
    values = burned.obj.data
    if not isinstance(values, np.ndarray) or values.dtype != np.float64 or values.shape != (n_face,):
        raise AssertionError(f"burn: a {type(values).__name__} {getattr(values, 'shape', None)}")
    triangles = [earcut_triangulate(np.vstack(r), np.cumsum([len(x) for x in r])) for r in polygon_rings]
    boxes = []
    for r, t in zip(polygon_rings, triangles):
        xy = np.vstack(r)[t]
        boxes.append(np.column_stack([xy[..., 0].min(1), xy[..., 1].min(1), xy[..., 0].max(1), xy[..., 1].max(1)]))
    candidate_pairs = int(sum(len(mesh.celltree.grid_hash.query_boxes(b)[0]) for b in boxes))
    centroids = mesh.centroids
    tol = max(mesh.celltree.default_tolerance(), 1e-9)

    def polygon_reference():
        want = np.full(n_face, np.nan)
        exempt = np.zeros(n_face, dtype=bool)
        for k, r in enumerate(polygon_rings):
            xy = np.vstack(r)
            box = (centroids >= xy.min(0) - 1.0).all(1) & (centroids <= xy.max(0) + 1.0).all(1)
            idx = np.flatnonzero(box)
            inside = even_odd(centroids[idx], r)
            want[idx[inside]] = ids[k]
            exempt[idx[ring_distance(centroids[idx], r) <= tol]] = True
        return want, exempt

    want, exempt = host(polygon_reference)
    is_poly = np.isnan(values) | (values < n_poly)
    bad = is_poly & ~exempt & ~((values == want) | (np.isnan(values) & np.isnan(want)))
    if bad.any():
        raise AssertionError(f"burn: {int(bad.sum())} polygon faces differ from the even-odd ray cast")
    face_xy = mesh.node_coordinates[mesh.face_node_connectivity]
    tree = cKDTree(centroids)
    reach = float(np.sqrt(np.nanmax(mesh.celltree._diag2)))

    def line_faces():
        crossed = []
        for k, xy in enumerate(lines):
            hit = set()
            for p, q in zip(xy[:-1], xy[1:]):
                cand = np.asarray(tree.query_ball_point((p + q) / 2.0, np.hypot(*(q - p)) / 2.0 + reach), dtype=np.int64)
                hit.update(cand[segment_crosses_polygon(p, q, face_xy[cand])].tolist())
            crossed.append(np.array(sorted(hit), dtype=np.int64))
        return crossed

    crossed = host(line_faces)
    on_line = np.flatnonzero((values >= n_poly) & (values < n_poly + n_line))
    crossers = {}
    for k, faces_k in enumerate(crossed):
        for f in faces_k:
            crossers.setdefault(int(f), set()).add(n_poly + k)
    stray = [f for f in on_line if int(values[f]) not in crossers.get(int(f), ())]
    if stray:
        raise AssertionError(f"burn: {len(stray)} faces burned with a channel's value that it does not cross")
    missed = sum(1 for f in crossers if not values[f] >= n_poly)
    point_face = mesh.locate_points(points)
    for k, f in enumerate(point_face):
        if f < 0 or not even_odd(points[k : k + 1], [face_xy[f]])[0]:
            raise AssertionError(f"burn: gauge {k} is not in face {f}")
    last = {int(f): n_poly + n_line + k for k, f in enumerate(point_face)}
    if any(values[f] != v for f, v in last.items()):
        raise AssertionError("burn: a gauge's face does not hold its value")
    on_point = np.flatnonzero(values >= n_poly + n_line)
    if sorted(on_point.tolist()) != sorted(last):
        raise AssertionError("burn: faces with a gauge's value hold no gauge")
    touched_v = touched.obj.data
    if (np.isfinite(values) & ~np.isfinite(touched_v)).any():
        raise AssertionError("burn: the all_touched set is not a superset of the centroid set")
    if not np.array_equal(np.isfinite(depth_burn.obj.data), np.isfinite(values)):
        raise AssertionError("burn: the depth column burned other faces than the id column")
    stage = "; ".join(f"{k} {v['total_s']:.3f} s x{v['count']}" for k, v in stages.items())
    report(
        f"14.2 burn_vector_geometry: {int(np.isfinite(values).sum())} faces burned ({int(is_poly.sum() - np.isnan(values).sum())} "
        f"by polygons, {len(on_line)} by channels, {len(on_point)} by gauges), all_touched {int(np.isfinite(touched_v).sum())} "
        f"(a superset); even-odd ray cast equal on every polygon face, {int(exempt.sum())} exempt within {tol:.1e} of an "
        f"edge; every channel face crossed by its channel ({missed} faces crossed by a channel hold no channel or gauge "
        f"value: grazes), every gauge in its face; {candidate_pairs} candidate (triangle, face) pairs of "
        f"{sum(len(t) for t in triangles)} earcut triangles; stages: {stage}; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in step_s.items())
    )

    # 14.3-14.4: the burned fields regridded.
    mode_r, mean_r = regridders["mode"], regridders["mean"]
    before = {k.__name__: k.launches for k in kernels}
    moded = wall("mode regrid", lambda: mode_r.regrid(burned))
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    source = torch.from_numpy(values).to(device).reshape(1, -1)
    targets = np.sort(rng.choice(mode_r._weights.n, size=400, replace=False))
    scale_ids = float(ids.max())
    max_err["window_select"] = check_apply(
        "14.3 burned ids -> 512 x 512 by overlap mode", mode_r, source, moded.obj.data.reshape(1, -1), window_select,
        rose, scale_ids,
        lambda got: (got[:, targets], reference_select(mode_r._weights, values[None], targets, "mode")),
    )
    before = {k.__name__: k.launches for k in kernels}
    meaned = wall("mean regrid", lambda: mean_r.regrid(depth_burn))
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    depth_values = depth_burn.obj.data
    max_err["window_reduce"] = check_apply(
        "14.4 burned depth -> 512 x 512 by overlap mean", mean_r, torch.from_numpy(depth_values).to(device).reshape(1, -1),
        meaned.obj.data.reshape(1, -1), window_reduce, rose, float(depth.max()),
        lambda got: (got, reference_linear(mean_r._weights, depth_values[None], relative=False)),
    )

    # 14.5: polygonize.
    polygons = wall("polygonize", lambda: xt.polygonize(burned))
    ok = ~np.isnan(values)
    i, j = mesh.edge_face_connectivity.T
    same = (i >= 0) & (j >= 0)
    same &= ok[np.maximum(i, 0)] & ok[np.maximum(j, 0)] & (values[np.maximum(i, 0)] == values[np.maximum(j, 0)])
    graph = scipy.sparse.coo_matrix((np.ones(int(same.sum())), (i[same], j[same])), shape=(n_face, n_face))
    _, labels = scipy.sparse.csgraph.connected_components(graph, directed=False)
    _, region_ok = np.unique(labels[ok], return_inverse=True)
    n_region = int(region_ok.max()) + 1
    if len(polygons) != n_region:
        raise AssertionError(f"polygonize: {len(polygons)} polygons, scipy finds {n_region} regions")
    region = np.full(n_face, -1, dtype=np.int64)
    region[ok] = region_ok
    region_value = np.zeros(n_region)
    region_value[region_ok] = values[ok]
    got_values = np.asarray(polygons["values"].to_numpy(), dtype=np.float64)
    if not np.array_equal(got_values, region_value):
        raise AssertionError("polygonize: a polygon's value differs from its region's")
    region_area = np.bincount(region_ok, weights=mesh.area[ok], minlength=n_region)
    pinch, outer, holes = host(lambda: region_rings(mesh, region, n_region))
    ring_area = np.array([abs(shoelace(shp.get_coordinates(g.exterior))) for g in polygons.geometry.to_numpy()])
    held = ~pinch
    off = np.abs(ring_area - (region_area + holes)) > 1e-9 * (region_area + holes)
    if (held & off).any():
        raise AssertionError(f"polygonize: {int((held & off).sum())} rings differ from their region's area and holes")
    if (held & (np.abs(outer - ring_area) > 1e-9 * ring_area)).any():
        raise AssertionError("polygonize: an exterior ring differs from the region's outer boundary loop")
    report(
        f"14.5 polygonize: {len(polygons)} polygons = scipy's {n_region} components, values equal; rings of "
        f"{int(held.sum())} regions held (area of faces plus holes within 1e-9; {int((holes > 0)[held].sum())} with "
        f"holes), {int(pinch.sum())} regions with a pinch vertex not held; {step_s['polygonize']:.3f} s"
    )

    # 14.6: the provinces' earcut mesh onto the 1M mesh by mode.
    province_gdf = gpd.GeoDataFrame({"id": ids[:n_poly]}, geometry=geometry[:n_poly])
    earcut = wall("earcut_triangulate_polygons", lambda: xt.earcut_triangulate_polygons(province_gdf, column="id"))
    t0 = time.perf_counter()
    earcut_r = xt.OverlapRegridder(earcut, mesh, method="mode")
    step_s["earcut mode regridder build"] = time.perf_counter() - t0
    before = {k.__name__: k.launches for k in kernels}
    on_mesh = wall("earcut mode regrid", lambda: earcut_r.regrid(earcut))
    rose = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    earcut_values = np.asarray(earcut.obj.data, dtype=np.float64)
    targets = np.sort(rng.choice(n_face, size=400, replace=False))
    err = check_apply(
        f"14.6 earcut mesh ({earcut.grid.n_face} triangles) -> 1M mesh by overlap mode", earcut_r,
        torch.from_numpy(earcut_values).to(device).reshape(1, -1), on_mesh.obj.data.reshape(1, -1), window_select, rose,
        scale_ids, lambda got: (got[:, targets], reference_select(earcut_r._weights, earcut_values[None], targets, "mode")),
    )
    max_err["window_select"] = max(max_err["window_select"], err)

    def wholly_inside():
        count = np.zeros(n_face, dtype=np.int64)
        near = np.zeros(n_face, dtype=bool)
        for r in polygon_rings:
            xy = np.vstack(r)
            idx = np.flatnonzero((centroids >= xy.min(0) - 2.0).all(1) & (centroids <= xy.max(0) + 2.0).all(1))
            count[idx[even_odd(centroids[idx], r)]] += 1
            near[idx[ring_distance(centroids[idx], r) < reach]] = True
        return (count == 1) & ~near

    inside_one = host(wholly_inside) & (values < n_poly)
    got_mesh = on_mesh.obj.data.cpu().numpy().ravel()
    if not np.array_equal(got_mesh[inside_one], values[inside_one]):
        raise AssertionError("earcut mode: differs from the burned field on a face wholly inside one province")
    polygon_faces = np.isfinite(want)
    differ = int((polygon_faces & ~((got_mesh == want) | np.isnan(got_mesh) & np.isnan(want))).sum())
    report(
        f"14.6 earcut mode equal to the burned ids on {int(inside_one.sum())} faces wholly inside one province; {differ} "
        f"faces along boundaries differ from the ray cast; build {step_s['earcut mode regridder build']:.3f} s"
    )

    # 14.7: the channels snapped to the mesh, a network, and the gauges filled.
    numeric = gpd.GeoDataFrame({"id": np.arange(n_line)}, geometry=[shp.LineString(xy) for xy in lines])
    snapped, snapped_gdf = wall("snap_to_grid", lambda: xt.snap_to_grid(numeric, mesh, 0.5))
    parts = wall("create_snap_to_grid_dataframe", lambda: xt.create_snap_to_grid_dataframe(numeric, mesh, 0.5))
    line_of_edge = snapped["line_index"].values
    edges = np.flatnonzero(np.isfinite(line_of_edge))
    en = mesh.edge_node_connectivity
    part_line, part_edge = parts["line_index"].to_numpy(), parts["edge_index"].to_numpy()
    if not np.array_equal(np.unique(part_edge), edges):
        raise AssertionError("snap_to_grid: its edges are not those the lines snap onto")
    claimed = set(zip(part_line.tolist(), part_edge.tolist()))
    if not all((int(line_of_edge[e]), int(e)) in claimed for e in edges):
        raise AssertionError("snap_to_grid: an edge went to a line that does not snap onto it")
    pieces = []
    for k in range(n_line):
        mine = np.unique(part_edge[part_line == k])
        if len(mine) == 0:
            raise AssertionError(f"snap_to_grid: line {k} snapped onto no edge")
        mid = mesh.node_coordinates[en[mine]].mean(axis=1)
        far = polyline_distance(mid, lines[k]) > reach + 0.5
        if far.any():
            raise AssertionError(f"snap_to_grid: {int(far.sum())} edges of line {k} lie out of its reach")
        nodes_k, local = np.unique(en[mine], return_inverse=True)
        local = local.reshape(-1, 2)
        g = scipy.sparse.coo_matrix((np.ones(len(mine)), (local[:, 0], local[:, 1])), shape=(len(nodes_k),) * 2)
        pieces.append(scipy.sparse.csgraph.connected_components(g, directed=False)[0])
    if max(pieces) != 1:
        raise AssertionError(f"snap_to_grid: the lines' snapped edges form {pieces} pieces")
    network = wall("Ugrid1d.from_geodataframe", lambda: xt.Ugrid1d.from_geodataframe(snapped_gdf))
    if network.n_edge != len(edges):
        raise AssertionError(f"network: {network.n_edge} edges for {len(edges)} snapped")
    node_dim = network.node_dimension
    known = np.full(network.n_node, np.nan)
    nearest = network.locate_nearest_node(points)
    known[nearest] = gauges["value"].to_numpy()
    fill_uda = xt.UgridDataArray(xt.xdata.DataArray(torch.from_numpy(known).to(device), dims=(node_dim,)), network)
    before = csr_matvec.launches
    filled = wall("network fill", lambda: fill_uda.ugrid.laplace_interpolate(**LAPLACE_SOLVE))
    info = dict(interpolate.last_solve_info)
    launches = csr_matvec.launches - before
    if launches != 1 + (info["degree"] - 1) + info["iterations"] * info["degree"]:
        raise AssertionError(f"network fill: {launches} csr_matvec launches for {info['iterations']} iterations")
    got = filled.obj.data.cpu().numpy()
    W = network.get_connectivity_matrix(node_dim, xy_weights=True)
    n_comp, comp = scipy.sparse.csgraph.connected_components(W)
    has_known = np.bincount(comp, weights=(~np.isnan(known)).astype(np.float64), minlength=n_comp) > 0
    empty = ~has_known[comp]
    if not np.isnan(got[empty]).all() or not np.isfinite(got[~empty]).all():
        raise AssertionError("network fill: components without a gauge must stay NaN, the rest finite")
    np.testing.assert_array_equal(got[~np.isnan(known)], known[~np.isnan(known)])
    residual = component_residuals(W, np.where(empty, 0.0, known), np.where(empty, 0.0, got), comp)
    if residual[has_known].max() > 10 * LAPLACE_SOLVE["atol"]:
        raise AssertionError(f"network fill: component residual {residual[has_known].max():.3e} > 10 * atol")
    prep = [v for k, v in interpolate._SYSTEMS.items() if k[0] == "laplace"][-1]
    indptr, indices, data64 = (prep["system"][k] for k in ("indptr", "indices", "data"))
    x = torch.from_numpy(rng.normal(size=(indptr.numel() - 1, 1))).to(device)
    path_launches = csr_matvec.launches  # the comparison's launch is no launch of the path
    max_err["csr_matvec"] = compare(
        csr_matvec(indptr, indices, data64, x), csr_matvec_plain(indptr, indices, data64, x), True, 0.0, 0.0
    )
    csr_matvec.launches = path_launches
    report(
        f"14.7 snap_to_grid: {len(edges)} edges, every one within {reach + 0.5:.3f} of its channel, each channel's "
        f"snapped edges one path ({len(part_edge) - len(edges)} shared edges went to the line of the longest part); "
        f"{step_s['snap_to_grid']:.3f} s; network {network.n_node} nodes, {n_comp} components, "
        f"{int((~np.isnan(known)).sum())} gauged nodes; fill {step_s['network fill']:.3f} s, {info['iterations']} "
        f"iterations at degree {info['degree']}, csr_matvec +{launches} (the formula's), every component's residual at "
        f"most {residual[has_known].max():.3e} (scipy, float64), csr_matvec bit-equal to its plain version"
    )

    # 14.8: conversions.
    subset = np.sort(rng.choice(n_face, size=VECTOR_FACES_FRAME, replace=False))
    frame_src = payload.isel(time=0).isel({face_dim: subset})
    frame = wall("to_geodataframe", lambda: frame_src.ugrid.to_geodataframe())
    back = wall("Ugrid2d.from_geodataframe", lambda: xt.Ugrid2d.from_geodataframe(frame))
    sub_grid = frame_src.grid
    np.testing.assert_array_equal(back.node_coordinates[back.face_node_connectivity],
                                  sub_grid.node_coordinates[sub_grid.face_node_connectivity])
    np.testing.assert_array_equal(frame["h"].to_numpy(), frame_src["h"].values)
    boundary = wall("bounding_polygon", lambda: mesh.bounding_polygon())
    area = abs(shoelace(shp.get_coordinates(boundary.exterior)))
    if abs(area - mesh.area.sum()) > 1e-9 * area:
        raise AssertionError(f"bounding_polygon: area {area!r}, the mesh's {mesh.area.sum()!r}")
    originals = np.sort(rng.choice(mesh.n_node, size=SNAP_NODE_COPIES, replace=False))
    xy = np.vstack([mesh.node_coordinates, mesh.node_coordinates[originals] + rng.uniform(-1e-6, 1e-6, (SNAP_NODE_COPIES, 2))])
    inverse, sx, sy = wall("snap_nodes", lambda: xt.snap_nodes(xy[:, 0], xy[:, 1], 1e-5))
    if len(sx) != mesh.n_node or not np.array_equal(inverse[mesh.n_node:], inverse[originals]):
        raise AssertionError("snap_nodes: a copy did not map onto its original")
    np.testing.assert_array_equal(np.column_stack([sx, sy])[inverse[: mesh.n_node]], mesh.node_coordinates)
    report(
        f"14.8 to_geodataframe of {VECTOR_FACES_FRAME} faces of phase 13's payload and back: node coordinates and values "
        f"bit-equal; bounding_polygon area equal to the mesh's within 1e-9; snap_nodes of {xy.shape[0]} nodes "
        f"({SNAP_NODE_COPIES} copies jittered by 1e-6) onto {len(sx)}; "
        + ", ".join(f"{k} {step_s[k]:.3f} s" for k in ("to_geodataframe", "Ugrid2d.from_geodataframe",
                                                        "bounding_polygon", "snap_nodes"))
    )

    counts = {k.__name__: k.launches for k in kernels}
    if counts["window_reduce"] != 1 or counts["window_select"] != 2 or counts["csr_matvec"] != launches:
        raise AssertionError(f"phase 14 launched {counts}")
    print(
        f"phase 14: {time.perf_counter() - t_phase:.1f} s, {host_s[0]:.1f} s of it host references; launches "
        f"{counts}; steps: " + ", ".join(f"{k} {v:.3f} s" for k, v in step_s.items()) + f" [{card}]"
    )
    return counts, max_err


XL_SIDE, XL_RASTER = 3163, 1024
#: Hours in the netCDF file: the writer's classic format (scipy's version
#: 1) stores each variable's start as a signed 32-bit offset, so every
#: variable but the last (the topology's scalar) must start below 2^31
#: bytes; with the 10M mesh's topology (360 MB) and 60 MB per hour of h
#: and q, 29 hours fit.
XL_NC_TIMES = 29
#: Hours in the zarr store (float32 h: 1.92 GB, two streamed blocks of
#: 45 and 3 hours under the default budget).
XL_ZARR_TIMES = 48
#: Hours of the streamed zarr mean that the grouped methods take.
XL_GROUPED_TIMES = 48
#: nnz of the XL weights from bench.py's generator (BENCH_XL_10M.json).
XL_BENCH_NNZ = 18_166_177
#: The packed int16 variable's CF encoding.
PACKED = {"scale_factor": 0.01, "add_offset": 10.0, "_FillValue": -32767}


def phase_stream(device, card, copy_gbps, main_results, payload):
    """Phase 15: the XL config (``bench.py``'s 3163^2 jittered quads onto a
    1024^2 raster) streamed from UGRID files through the card.  The
    OverlapRegridder mean and median built (host stages, nnz, w_max) and
    applied in memory at E = 20 (one launch each: kernel, bound, plain and
    library times; held to the plain version and to host references on 2
    slices); an hourly (time, face) float32 payload with 1 % NaN and an
    int16 packed with scale_factor/add_offset/_FillValue written through
    ``.ugrid.to_netcdf`` (T = 29, as many hours as the classic format
    holds) and ``.ugrid.to_zarr`` (float32, T = 48) in a temporary
    directory removed at the end, opened with ``lazy=True`` and each lazy
    payload regridded by mean and median under the default
    ``APPLY_CHUNK_BYTES``: one launch per streamed block (each file in more
    than one block), the card's peak allocation within the budget plus the
    weights uploaded during the call and the result, every block read
    within the budget (and under half the variable where the budget allows
    it), the result bit-equal to the eager regrid of the payload written;
    a lazy
    ``isel(time=slice(0, 24))`` reading just its rows.  Then the grouped
    methods on the first 48 hours of the streamed zarr mean, each on the card,
    against the same method on a CPU copy and a numpy formula; and on
    phase 13's (time=20, face=1M) payload a resample mean and a groupby
    median through phase 3's overlap mean and median.  Returns (launch
    counts, largest |kernel - plain|, the 10M kernel times)."""
    import os
    import shutil
    import tempfile

    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid import apply as apply_module
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.apply import device_weights
    from xugrid_tpu_torch.regrid.regridder import APPLY_CHUNK_BYTES
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.utils.profiling import timings
    from xugrid_tpu_torch.xdata.lazy import is_lazy, max_single_load

    t_phase = time.perf_counter()
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    max_err = {"window_reduce": 0.0, "window_select": 0.0}
    timed_10m = {}
    methods = (("mean", window_reduce), ("median", window_select))

    def report(line):
        print(f"  {line} [{card}]")

    def uncounted(fn):
        """``fn()`` with its launches left out of the path's counts (a
        reference or a timing)."""
        saved = {k: k.launches for k in kernels}
        try:
            return fn()
        finally:
            for k, n in saved.items():
                k.launches = n

    def launches_of(fn):
        before = {k.__name__: k.launches for k in kernels}
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches - before[k.__name__] for k in kernels}

    def device_weight_bytes(regridder):
        """Bytes of the regridder's weight copies on the card."""
        return sum(t.numel() * t.element_size() for pair in regridder._device_weights.values() for t in pair)

    # 15.1: the meshes and the weights.
    rng = np.random.default_rng(42)  # bench.py's seed: its jitter
    t0 = time.perf_counter()
    (verts, faces), _ = bench_meshes(XL_SIDE, XL_RASTER, rng)
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    target = raster_dataarray(XL_RASTER, np.zeros((XL_RASTER, XL_RASTER), np.float32), descending=False, extent=XL_SIDE)
    mesh_s = time.perf_counter() - t0
    m, n, face_dim = mesh.n_face, XL_RASTER * XL_RASTER, mesh.face_dimension
    print(f"phase 15: the XL config streamed, {m} faces onto a {XL_RASTER} x {XL_RASTER} raster [{card}]")
    regridders = {}
    for method, _ in methods:
        timings.reset()
        t0 = time.perf_counter()
        regridders[method] = xt.OverlapRegridder(mesh, target, method=method)
        build_stages(f"15.1 OverlapRegridder({method})", time.perf_counter() - t0)
    csr = regridders["mean"]._weights
    w_max = regridders["mean"]._padded.w_max
    report(
        f"15.1 meshes {mesh_s:.3f} s; weights nnz {csr.nnz} (bench.py's generator: {XL_BENCH_NNZ}), w_max {w_max}, "
        f"{csr.n} targets"
    )

    # 15.2: the in-memory apply at E = 20, one launch per method.
    gen = torch.Generator(device=device)
    gen.manual_seed(15)

    def hourly(n_time):
        """(n_time, m) float32 on the card: half steps (ties for the
        median), 1 % NaN."""
        x = torch.round(torch.randn((n_time, m), generator=gen, device=device) * 2.0) / 2.0
        return torch.where(torch.rand((n_time, m), generator=gen, device=device) < 0.01, torch.nan, x)

    source = hourly(N_EXTRA)
    scale = float(source.nan_to_num().abs().max())
    sample = np.sort(np.random.default_rng(15).choice(n, size=400, replace=False))
    host_slices = source[:2].cpu().numpy()
    for method, kernel in methods:
        regridder = regridders[method]
        out, rose = launches_of(lambda: regridder.regrid(source))
        if method == "mean":
            reference = lambda got: (got[:2], reference_linear(csr, host_slices, relative=False))  # noqa: E731
        else:
            reference = lambda got: (got[:2][:, sample], reference_select(csr, host_slices, sample, "median"))  # noqa: E731
        flat = out.reshape(N_EXTRA, n)
        max_err[kernel.__name__] = max(max_err[kernel.__name__], check_apply(
            f"15.2 {method} E={N_EXTRA} (2 slices against the host)", regridder, source, flat, kernel, rose, scale,
            reference,
        ))
        idx, w = device_weights(regridder._padded, torch.float32, device, regridder._device_weights)
        red = regridder._reduction
        kernel_ms = uncounted(lambda: cuda_time_ms(lambda: kernel(source, idx, w, red), reps=5))
        plain_ms = cuda_time_ms(lambda: reduce.reduce_windows(source.t(), idx, w, red), reps=3, warmup=1, inner=1)
        library_ms = None
        if kernel is window_reduce:
            library = torch.sparse_csr_tensor(
                *(torch.from_numpy(a.astype(np.int32)).to(device) for a in (csr.indptr, csr.indices)),
                torch.from_numpy(csr.data.astype(np.float32)).to(device), size=(csr.n, csr.m),
            )
            sourceT = source.t().contiguous()
            library_ms = cuda_time_ms(lambda: torch.sparse.mm(library, sourceT), reps=5)
            del library, sourceT
            operations = 2 * csr.nnz * N_EXTRA
        else:
            # As phase 4's: torch.nanquantile over the pre-gathered (n, E,
            # w) windows, pads NaN (the gather and the weight gate left out).
            gathered = reduce.gather_windows(source.t(), idx)
            library_ms = cuda_time_ms(lambda: torch.nanquantile(gathered, red.p / 100.0, dim=-1), reps=3)
            del gathered
            operations = csr.nnz * N_EXTRA * int(np.ceil(np.log2(max(w_max, 2))))
        true_bytes = csr.nnz * 8 + m * N_EXTRA * 4 + n * N_EXTRA * 4
        bound, bound_by = bound_ms(true_bytes, operations, "float32", copy_gbps)
        timed_10m[method] = {
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by,
        }
        library_text = (
            f"torch.sparse.mm {library_ms:.4f} ms" if kernel is window_reduce
            else f"torch.nanquantile over the gathered {tuple(idx.shape[:1]) + (N_EXTRA, idx.shape[1])} windows "
            f"{library_ms:.4f} ms"
        )
        report(
            f"15.2 {method} E={N_EXTRA} at {m} faces ({kernel.__name__}): kernel {kernel_ms:.4f} ms, bound {bound:.4f} ms by "
            f"{bound_by} ({100 * bound / kernel_ms:.1f} % of it), plain {plain_ms:.3f} ms, library {library_text}; "
            f"true bytes {true_bytes}, {true_bytes / (kernel_ms * 1e-3) / 1e9:.1f} GB/s"
        )
        del out, flat
    del source
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        # 15.3: the source files.
        def stamps(n_time):
            return np.datetime64("2021-07-14T00", "ns") + np.arange(n_time) * np.timedelta64(1, "h")

        fill = PACKED["_FillValue"]
        h_nc = hourly(XL_NC_TIMES)
        q_nc = torch.where(torch.isnan(h_nc), float(fill), torch.round(h_nc / PACKED["scale_factor"])).to(torch.int16)
        # The packed variable as the reader decodes it (NaN at the fill,
        # then the scale and the offset in float64).
        q_decoded = torch.where(q_nc == fill, torch.nan, q_nc.double()) * PACKED["scale_factor"] + PACKED["add_offset"]
        h_zarr = hourly(XL_ZARR_TIMES)
        torch.cuda.synchronize()
        files = {}
        for fmt, writer, variables, n_time in (
            ("netCDF", "to_netcdf", {"h": h_nc, "q": q_nc}, XL_NC_TIMES),
            ("zarr", "to_zarr", {"h": h_zarr}, XL_ZARR_TIMES),
        ):
            ds = xt.xdata.Dataset(
                {name: (("time", face_dim), data, dict(PACKED) if name == "q" else {"units": "m"})
                 for name, data in variables.items()},
                coords={"time": stamps(n_time)},
            )
            path = os.path.join(tmp, "hourly_10M.nc" if fmt == "netCDF" else "hourly_10M.zarr")
            t0 = time.perf_counter()
            getattr(xt.UgridDataset(ds, [mesh]).ugrid, writer)(path)
            write_s = time.perf_counter() - t0
            files[fmt] = path
            report(
                f"15.3 {fmt}: {', '.join(f'{k} ({n_time}, {m}) {v.dtype}' for k, v in variables.items())}, "
                f"{path_mb(path):.3f} MB written in {write_s:.3f} s"
            )

        # 15.4: the lazy opens.
        opened = {}
        for fmt, opener in (("netCDF", xt.open_dataset), ("zarr", xt.open_zarr)):
            t0 = time.perf_counter()
            opened[fmt] = opener(files[fmt], lazy=True)
            open_s = time.perf_counter() - t0
            if not opened[fmt].grid.equals(mesh):
                raise AssertionError(f"15.4 {fmt}: the opened grid does not equal 15.1's mesh")
            names = [name for name in opened[fmt].obj.data_vars if name in ("h", "q")]
            for name in names:
                if not is_lazy(opened[fmt][name].obj.data):
                    raise AssertionError(f"15.4 {fmt} {name}: not a LazyArray")
            report(f"15.4 {fmt} opened lazily in {open_s:.3f} s: {', '.join(names)} LazyArrays, the grid equal to 15.1's")

        # 15.5: the streamed regrids.
        streams = (
            ("netCDF h", opened["netCDF"]["h"], h_nc),
            ("netCDF q (int16 packed)", opened["netCDF"]["q"], q_decoded),
            ("zarr h", opened["zarr"]["h"], h_zarr),
        )
        streamed = {}
        for label, uda, written in streams:
            data = uda.obj.data
            for method, kernel in methods:
                regridder = regridders[method]
                rows = regridder._slices_per_chunk(max(data.dtype.itemsize, 4))
                events = []
                real = getattr(apply_module, kernel.__name__)

                def evented(*args, real=real, events=events, **kwargs):
                    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = real(*args, **kwargs)
                    stop.record()
                    events.append((start, stop))
                    return out

                del data.load_log[:]
                timings.reset()
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                weights_before = device_weight_bytes(regridder)
                torch.cuda.reset_peak_memory_stats()
                setattr(apply_module, kernel.__name__, evented)
                t0 = time.perf_counter()
                try:
                    out, rose = launches_of(lambda: regridder.regrid(uda))
                finally:
                    setattr(apply_module, kernel.__name__, real)
                wall_s = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                stages = timings.summary()
                chunks = stages["regrid.lazy_read"]["count"]
                if chunks != -(-data.shape[0] // rows) or rose[kernel.__name__] != chunks or sum(rose.values()) != chunks:
                    raise AssertionError(f"15.5 {label} {method}: {chunks} blocks, launches {rose}")
                result = out.data
                if not isinstance(result, torch.Tensor) or result.device != device or out.dims != ("time", "y", "x"):
                    raise AssertionError(f"15.5 {label} {method}: {type(result).__name__} {out.dims}")
                # Only the weights uploaded during the call (the float64
                # copy for the packed variable): the float32 copy of 15.2
                # was on the card before ``base`` was read.
                weights_bytes = device_weight_bytes(regridder) - weights_before
                result_bytes = result.numel() * result.element_size()
                if peak > APPLY_CHUNK_BYTES + weights_bytes + result_bytes:
                    raise AssertionError(
                        f"15.5 {label} {method}: peak {peak} bytes above the budget {APPLY_CHUNK_BYTES} + weights "
                        f"{weights_bytes} + result {result_bytes}"
                    )
                single = max_single_load(data)
                if single > APPLY_CHUNK_BYTES:
                    raise AssertionError(f"15.5 {label} {method}: a block read of {single} bytes, above the budget")
                if data.shape[0] > 2 * rows and single >= data.nbytes / 2:
                    raise AssertionError(f"15.5 {label} {method}: a block read of half the variable or more")
                # Each (target, slice) is reduced in window order whatever
                # the block: the streamed result equals the eager one.
                want = uncounted(lambda: regridder.regrid(written).reshape(result.shape))
                compare(result, want, True, 0.0, 0.0)
                kernel_ms = [start.elapsed_time(stop) for start, stop in events]
                read_s, upload_s = stages["regrid.lazy_read"]["total_s"], stages["regrid.lazy_upload"]["total_s"]
                report(
                    f"15.5 {label} by {method}: {chunks} block(s) of up to {rows} rows ({data.shape[0]} in all), one "
                    f"{kernel.__name__} launch each; read + decode {read_s:.3f} s ({read_s / chunks:.3f} s per block), "
                    f"host-to-device {upload_s:.3f} s ({upload_s / chunks:.3f} per block), kernel ms per block "
                    f"{', '.join(f'{t:.3f}' for t in kernel_ms)}; wall {wall_s:.3f} s, "
                    f"{data.nbytes / wall_s / 1e9:.3f} GB/s of decoded payload streamed; largest block read {single} "
                    f"bytes ({single / data.nbytes:.3f} of the variable's {data.nbytes}); peak allocation {peak} bytes "
                    f"<= budget {APPLY_CHUNK_BYTES} + weights uploaded {weights_bytes} + result {result_bytes}; "
                    "bit-equal to the eager regrid of the payload written"
                )
                streamed[(label, method)] = (out, chunks)
        for fmt in files:
            if max(chunks for (label, _), (_, chunks) in streamed.items() if label.startswith(fmt)) < 2:
                raise AssertionError(f"15.5 {fmt}: no variable streamed in more than one block")
        lazy_h = opened["netCDF"]["h"]
        part = lazy_h.isel(time=slice(0, 24))
        if not isinstance(part, xt.UgridDataArray) or not is_lazy(part.obj.data):
            raise AssertionError("15.5 isel(time=slice(0, 24)): not a lazy UgridDataArray")
        start_log = len(part.obj.data.load_log)
        values = part.values
        reads = part.obj.data.load_log[start_log:]
        if reads != [24 * m * 4] * 2:
            raise AssertionError(f"15.5 isel(time=slice(0, 24)): reads {reads}")
        bit_equal("15.5 isel(time=slice(0, 24))", torch.from_numpy(values).to(device), h_nc[:24].cpu().numpy(), device)
        report(
            "15.5 uda.isel(time=slice(0, 24)) of the netCDF h stays a lazy UgridDataArray; .values reads its 24 rows "
            f"once ({24 * m * 4} bytes, logged by the slice and by the file's array), bit-equal to the rows written"
        )
        del h_nc, q_nc, q_decoded, h_zarr, opened, streams
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 15.6: the grouped methods on the streamed (time=48, y, x) mean.
    nt = XL_GROUPED_TIMES
    res = streamed[("zarr h", "mean")][0].isel(time=slice(0, nt))
    res = res.assign_coords(hour=("time", np.arange(nt) % 24))
    hours = np.arange(float(nt))
    on_cpu = res.copy(deep=False, data=res.data.cpu())
    Hf = res.values
    H = Hf.astype(np.float64)
    area_np = np.abs(res["dy"].values[:, None] * res["dx"].values[None, :])

    def area(da):
        return xt.xdata.DataArray(torch.from_numpy(area_np).to(da.data.device), dims=("y", "x"))

    def numeric(da):
        return da.assign_coords(time=hours)

    def rolling_ref():
        out = np.full_like(H, np.nan)
        for t in range(5, nt):
            out[t] = H[t - 5 : t + 1].mean(axis=0)  # min_periods = 6: NaN with any NaN
        return out

    def coarsen_ref():
        with warnings_ignored():
            by_x = np.nanmean(H.reshape(nt, XL_RASTER, XL_RASTER // 4, 4), axis=3)
            return np.nanmean(by_x.reshape(nt, XL_RASTER // 4, 4, XL_RASTER // 4), axis=2)

    def weighted_ref():
        valid = ~np.isnan(H)
        return (np.where(valid, H, 0.0) * area_np).sum(axis=(1, 2)) / (valid * area_np).sum(axis=(1, 2))

    def polyfit_ref():
        flat = H.reshape(nt, -1)
        out = np.full((2, flat.shape[1]), np.nan)
        ok = ~np.isnan(flat).any(axis=0)
        out[:, ok] = np.linalg.lstsq(np.vander(hours, 2), flat[:, ok], rcond=None)[0]
        return out.reshape(2, XL_RASTER, XL_RASTER)

    def nan_groups(groups):
        with warnings_ignored():
            return np.stack([np.nanmean(H[g], axis=0) for g in groups])

    grouped = (
        ("resample(time='1D').mean()", lambda da: da.resample(time="1D").mean(),
         lambda: nan_groups([slice(day, day + 24) for day in range(0, nt, 24)]), 1e-12),
        ("groupby('hour').mean()", lambda da: da.groupby("hour").mean(),
         lambda: nan_groups([np.arange(k, nt, 24) for k in range(24)]), 1e-12),
        ("rolling(time=6).mean()", lambda da: da.rolling(time=6).mean(), rolling_ref, 1e-12),
        ("coarsen(x=4, y=4).mean()", lambda da: da.coarsen(x=4, y=4).mean(), coarsen_ref, 1e-12),
        ("weighted(cell area).mean(('x', 'y'))", lambda da: da.weighted(area(da)).mean(("x", "y")), weighted_ref, 1e-12),
        ("polyfit('time', 1)", lambda da: numeric(da).polyfit("time", 1)["polyfit_coefficients"], polyfit_ref, 1e-9),
        ("interp(time=midpoints)", lambda da: numeric(da).interp(time=hours[:-1] + 0.5),
         lambda: (H[:-1] + H[1:]) / 2.0, 1e-12),
        ("differentiate('time')", lambda da: numeric(da).differentiate("time"), lambda: np.gradient(H, hours, axis=0), 1e-12),
        # numpy's trapezoid adds the float32 neighbours in float32.
        ("integrate('time')", lambda da: numeric(da).integrate("time"),
         lambda: ((Hf[1:] + Hf[:-1]).astype(np.float64) / 2.0).sum(axis=0), 1e-12),
        ("stack(cell=('y', 'x')).unstack()", lambda da: da.stack(cell=("y", "x")).unstack("cell"),
         lambda: Hf, 0.0),
    )
    lines = []
    for label, fn, formula, rtol in grouped:
        got = fn(res)
        data = got.data
        if not isinstance(data, torch.Tensor) or data.device != device:
            raise AssertionError(f"15.6 {label}: the result is not a tensor on {device}")
        ms = card_ms(lambda: fn(res))
        cpu = fn(on_cpu).data
        if cpu.device.type != "cpu":
            raise AssertionError(f"15.6 {label}: the CPU copy's result left the CPU")
        magnitude = float(np.nanmax(np.abs(H)))
        if rtol == 0.0:
            compare(data, cpu, True, 0.0, 0.0)
            compare(data, torch.from_numpy(formula()), True, 0.0, 0.0)
        else:
            compare(data, cpu, False, rtol, rtol * magnitude)
            atol = rtol * magnitude * (nt if "integrate" in label else 1)
            compare(data, torch.from_numpy(formula()), False, max(rtol, 1e-12), atol)
        lines.append(f"{label} {ms:.3f} ms")
    report(
        f"15.6 grouped methods on the first {nt} hours of the streamed zarr mean ({nt}, {XL_RASTER}, {XL_RASTER}), "
        "each a tensor on the card, held to the "
        "same method on a CPU copy and to a numpy formula (float64 rtol 1e-12; polyfit 1e-9; stack/unstack bit-equal): "
        + ", ".join(lines)
    )

    # 15.6: grouped results of phase 13's payload through phase 3's regridders.
    main = {method: regridder for _, method, _, regridder, *_ in main_results}
    h13 = payload["h"].obj
    days = h13["time"].values
    stamps13 = np.datetime64("2021-01-01", "ns") + np.round(days * 86400e9).astype("timedelta64[ns]")
    h13 = h13.assign_coords(time=stamps13, week=("time", (days // 7).astype(np.int64)))
    H13 = h13.values.astype(np.float64)
    bins = (stamps13 - stamps13[0].astype("datetime64[D]")) // np.timedelta64(5, "D")
    feeds = (
        ("resample(time='5D').mean()", lambda: h13.resample(time="5D").mean(), "mean", window_reduce,
         [np.flatnonzero(bins == b) for b in range(int(bins.max()) + 1)], np.nanmean),
        ("groupby('week').median()", lambda: h13.groupby("week").median(), "median", window_select,
         [np.flatnonzero((days // 7) == w) for w in np.unique(days // 7)], np.nanmedian),
    )
    scale13 = float(np.nanmax(np.abs(H13)))
    for label, fn, method, kernel, groups, numpy_fn in feeds:
        grouped_da = fn()
        with warnings_ignored():
            want = np.stack([numpy_fn(H13[g], axis=0) if len(g) else np.full(H13.shape[1], np.nan) for g in groups])
        compare(grouped_da.data, torch.from_numpy(want), False, 1e-12, 1e-12 * scale13)
        regridder = main[method]
        out, rose = launches_of(lambda: regridder.regrid(grouped_da))
        src = grouped_da.data
        sample13 = np.sort(np.random.default_rng(16).choice(regridder._weights.n, size=400, replace=False))
        if method == "mean":
            reference = lambda got: (got, reference_linear(regridder._weights, src.cpu().numpy(), relative=False))  # noqa: E731
        else:
            reference = lambda got: (  # noqa: E731
                got[:, sample13], reference_select(regridder._weights, src.cpu().numpy(), sample13, "median")
            )
        max_err[kernel.__name__] = max(max_err[kernel.__name__], check_apply(
            f"15.6 phase 13's h {label} ({tuple(src.shape)}, float64 within numpy's nan-reduction at rtol 1e-12) "
            f"-> {T_SIDE} x {T_SIDE} by overlap {method}", regridder, src, out.obj.data.reshape(src.shape[0], -1), kernel, rose,
            scale13, reference,
        ))

    counts = {k.__name__: k.launches for k in kernels}
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s, launches {counts} [{card}]")
    return counts, max_err, timed_10m


OCEAN_SIDE = 1000
#: Share of the ocean grid's cells masked as land.
OCEAN_LAND = 0.10
VOXEL_SHAPE, VOXEL_TARGET = (40, 500, 500), (20, 250, 250)
VOXEL_EXTRAS = (1, 4)
#: Ranks of the spawned gloo world, both on the one card.
SHARDED_WORLD = 2
SHARDED_TIMEOUT_S = 300
SMOOTH_STEPS = 4


def ocean_bounds(side, extent, rng):
    """(side, side, 4) corner bounds of a curvilinear ocean grid covering
    [0, extent]^2, as ROMS or NEMO output gives it: the grid rotated by 20
    degrees, its lines warped by sines, cells about 1.3 wide; the cells
    where a smooth seeded field exceeds its 90th percentile are land, NaN
    in both bounds.  Returns (x_bounds, y_bounds, land)."""
    angle = np.deg2rad(20.0)
    span = extent * (np.cos(angle) + np.sin(angle)) + 20.0
    h = span / side
    j, i = np.meshgrid(np.arange(side + 1.0), np.arange(side + 1.0), indexing="ij")
    u = i * h - span / 2 + 4.0 * np.sin(j * h / 60.0)
    v = j * h - span / 2 + 4.0 * np.sin(i * h / 75.0)
    c, s = np.cos(angle), np.sin(angle)
    node_x = extent / 2 + c * u - s * v
    node_y = extent / 2 + s * u + c * v

    def corners(a):
        return np.stack([a[:-1, :-1], a[:-1, 1:], a[1:, 1:], a[1:, :-1]], axis=-1)

    xb, yb = corners(node_x), corners(node_y)
    cx, cy = xb.mean(axis=-1), yb.mean(axis=-1)
    field = np.sin(cx / 83.0) * np.cos(cy / 59.0) + 0.5 * np.sin((cx + cy) / 151.0) + rng.normal(0.0, 0.05, cx.shape)
    land = field > np.quantile(field, 1.0 - OCEAN_LAND)
    xb[land] = np.nan
    yb[land] = np.nan
    return xb, yb, land


def edges_over_depth(thickness):
    """Ascending layer edges from -40 to 0 (exactly) of the given layer
    thicknesses, scaled to sum to 40, along the first axis."""
    thickness = thickness * (40.0 / thickness.sum(axis=0, keepdims=True))
    edges = np.concatenate([np.full((1,) + thickness.shape[1:], -40.0), -40.0 + np.cumsum(thickness, axis=0)])
    edges[-1] = 0.0
    return edges


def voxel_dataset(shape, source):
    """The coordinates of a voxel model over z in [-40, 0] and [0, 500]^2:
    cells of 500 / n in y and x; z layers of 2.0 (the target) or, for the
    source, 0.5 thick at the surface to 1.5 at depth (``zbounds``)."""
    import xugrid_tpu_torch as xt

    nz, ny, nx = shape
    coords = {"y": (np.arange(ny) + 0.5) * 500.0 / ny, "x": (np.arange(nx) + 0.5) * 500.0 / nx}
    if source:
        edges = edges_over_depth(np.linspace(1.5, 0.5, nz))
        coords["z"] = 0.5 * (edges[:-1] + edges[1:])
        coords["zbounds"] = (("z", "nbounds"), np.column_stack([edges[:-1], edges[1:]]))
    else:
        coords["z"] = -40.0 + (np.arange(nz) + 0.5) * 40.0 / nz
    return xt.xdata.Dataset(coords=coords)


def layer_bounds(n_layer, ny, nx, rng):
    """(n_layer, ny * nx, 2) ascending layer bounds of a geological layer
    model over [-40, 0]: per column, thicknesses that vary smoothly in
    space and at random, each column spanning [-40, 0] exactly."""
    yy, xx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    k = np.arange(n_layer)[:, None]
    thick = (
        1.0 + 0.6 * np.sin(xx.ravel()[None] / 37.0 + k) * np.cos(yy.ravel()[None] / 53.0 - 0.5 * k)
        + rng.uniform(-0.3, 0.3, (n_layer, ny * nx))
    )
    edges = edges_over_depth(np.clip(thick, 0.1, None))
    return np.stack([edges[:-1], edges[1:]], axis=-1)


def unknown_system(W, values, coords):
    """The Laplace fill's unknown system (D - W)_uu x_u = W_uk x_k in the
    windowed layout of ``sharded_cg_solve``, the unknowns in Hilbert
    order (``partition_order`` of their coordinates).  Returns (indices
    (n_u, w) -1 padded, weights, diag, b, the scipy matrix)."""
    import scipy.sparse

    from xugrid_tpu_torch.parallel import partition_order

    W = W.tocsr()
    unknown = np.flatnonzero(np.isnan(values))
    unknown = unknown[partition_order(coords[unknown])]
    known = np.flatnonzero(~np.isnan(values))
    diag = np.asarray(W.sum(axis=1)).ravel()[unknown]
    A = (scipy.sparse.diags(diag) - W[unknown][:, unknown]).tocsr()
    b = W[unknown][:, known] @ values[known]
    off = (-W[unknown][:, unknown]).tocsr()
    off.sort_indices()
    lengths = np.diff(off.indptr)
    w_max = int(lengths.max())
    slot = np.arange(w_max)[None, :] < lengths[:, None]
    indices = np.full((len(unknown), w_max), -1, np.int64)
    weights = np.zeros((len(unknown), w_max))
    indices[slot] = off.indices
    weights[slot] = off.data
    return indices, weights, diag, b, A


def smoothing_reference(neighbors, values, n_steps):
    """``sharded_laplace_smooth`` in numpy: per step 0.5 v + 0.5 nanmean
    over the neighbours and the face itself, float64."""
    v = values.astype(np.float64)
    for _ in range(n_steps):
        stacked = np.where(neighbors >= 0, v[np.maximum(neighbors, 0)], np.nan)
        with warnings_ignored():
            v = 0.5 * v + 0.5 * np.nanmean(np.concatenate([stacked, v[:, None]], axis=1), axis=1)
    return v


def sharded_rank(argv) -> int:
    """One rank of 16.3's spawned gloo world: ``chip_smoke.py
    --sharded-rank RANK WORLD DIR DEVICE``.  Joins through the file store
    in DIR, runs the sharded regrid, CG and smoothing on DIR/inputs.npz
    on DEVICE (the card: its messages staged through host memory, as a
    gloo group's are) and writes DIR/rank{RANK}.npz."""
    import torch
    import torch.distributed as dist

    from xugrid_tpu_torch.core.sparse import PaddedCSR
    from xugrid_tpu_torch.parallel import ShardedRegrid, sharded_cg_solve, sharded_laplace_smooth
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select

    rank, world, tmp, device = int(argv[0]), int(argv[1]), argv[2], torch.device(argv[3])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kernels = (window_reduce, window_select, csr_matvec)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank)
    out = {}
    try:
        with np.load(f"{tmp}/inputs.npz") as data:
            inputs = dict(data)
        padded = PaddedCSR(inputs["indices"], inputs["weights"], int(inputs["n"]), int(inputs["m"]),
                           inputs["indices"].shape[1])
        field = torch.from_numpy(inputs["field"]).to(device)
        for method in ("halo", "allgather"):
            for label, reduction in (("mean", reduce.mean), ("median", reduce.ABSOLUTE_OVERLAP_METHODS["median"])):
                sharded = ShardedRegrid(None, padded, reduction, method=method, device=device)
                local = sharded.put_source(field)
                result = sharded.gather(sharded(local))
                torch.cuda.synchronize()
                if rank == 0:
                    out[f"{method}_{label}"] = result.cpu().numpy()
                counted = {k.__name__: k.launches for k in kernels}
                dist.barrier()
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    sharded(local)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                for k in kernels:
                    k.launches = counted[k.__name__]
                out[f"{method}_{label}_numbers"] = np.array([
                    sharded.method == method, sharded.exchanged_bytes,
                    0 if sharded.plan is None else sharded.plan.R, statistics.median(times) * 1e3,
                    sharded.exchange.staged_bytes,
                ])
        before = csr_matvec.launches
        x, k = sharded_cg_solve(None, inputs["cg_indices"], inputs["cg_weights"], inputs["cg_diag"], inputs["cg_b"],
                                atol=LAPLACE_SOLVE["atol"], maxiter=LAPLACE_SOLVE["maxiter"], device=device)
        out["cg_numbers"] = np.array([k, csr_matvec.launches - before])
        if rank == 0:
            out["cg_x"] = x
        out["smooth"] = sharded_laplace_smooth(
            None, inputs["smooth_neighbors"], inputs["smooth_values"], n_steps=SMOOTH_STEPS, device=device
        )
        out["launches"] = np.array([k.launches for k in kernels])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **out)
    return 0


def traced_apply(argv) -> int:
    """16.4 in a process of its own: ``chip_smoke.py --traced-apply DIR
    DEVICE`` applies DIR/apply.npz's weights (mean) to its source on DEVICE
    under ``trace(DIR)`` and ``annotate("phase16.apply")``, and saves the
    result to DIR/applied.npy and its launches to DIR/launches.npy.  (In
    this script's own process the profiler keeps fewer device activities
    with every session, and none by phase 16: phase 7's profiles keep 4 of
    10 launches, phase 8's none.)"""
    import torch

    from xugrid_tpu_torch.core.sparse import PaddedCSR
    from xugrid_tpu_torch.regrid import reduce
    from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights
    from xugrid_tpu_torch.utils.profiling import annotate, trace

    tmp, device = argv[0], torch.device(argv[1])
    with np.load(f"{tmp}/apply.npz") as data:
        inputs = dict(data)
    indices = inputs["indices"]
    padded = PaddedCSR(indices, inputs["weights"], int(inputs["n"]), int(inputs["m"]), indices.shape[1])
    source = torch.from_numpy(inputs["source"]).to(device)
    with trace(tmp):
        with annotate("phase16.apply"):
            out = apply_weights(padded, source, reduce.mean, padded.n)
            if device.type == "cuda":
                torch.cuda.synchronize()
    np.save(f"{tmp}/applied.npy", out.cpu().numpy())
    np.save(f"{tmp}/launches.npy", np.array([window_reduce.launches]))
    return 0


def run_processes(argument_lists, timeout=SHARDED_TIMEOUT_S):
    """``chip_smoke.py`` with each argument list in a process of its own,
    all started together and joined within ``timeout`` seconds (killed
    otherwise); raises with the output of any that failed."""
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, *map(str, args)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        for args in argument_lists
    ]
    logs = []
    try:
        deadline = time.perf_counter() + timeout
        for proc in procs:
            out, _ = proc.communicate(timeout=max(deadline - time.perf_counter(), 1.0))
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [i for i, proc in enumerate(procs) if proc.returncode != 0]
    if failed:
        raise AssertionError(
            "spawned processes failed:\n" + "\n".join(f"{argument_lists[i]}:\n{logs[i][-3000:]}" for i in failed)
        )


def phase_structured_sharded(device, card, copy_gbps, inputs, main_results, meshes):
    """Phase 16: curvilinear and 3-D structured grids, the sharded regrid
    and CG, and the profiler hooks.

    16.1 A 1000 x 1000 curvilinear ocean grid (rotated, warped, 10 % of
    its cells land) given as (N, M, 4) corner bounds, with (time=20, eta,
    xi) float32 data on the card, through ``UgridDataArray.from_structured2d
    (x_bounds=, y_bounds=)`` and ``OverlapRegridder`` mean (window_reduce)
    and mode (window_select) onto phase 3's 1M mesh: one launch each, held
    to the plain version and the host references; kernel ms and share of
    the bound.
    16.2 Voxels (40, 500, 500), their layers 0.5 thick at the surface to
    1.5 at depth, onto (20, 250, 250) voxels 2 thick by
    ``StructuredGrid3d.overlap``, and a 40-layer model of varying
    thickness per column over the same 500 x 500 footprint
    (``ExplicitStructuredGrid3d``) onto those voxels: the weights through
    ``PaddedCSR.from_coo`` and ``apply_weights`` mean (window_reduce) at
    E = 1 and 4, held to the plain version and ``reference_linear``; every
    target voxel's weights sum to its volume (1e-9 relative): both models
    span its column.
    16.3 Phase 3's 1M overlap weights in Hilbert order (``hilbert_layout``)
    and the 1M Delaunay fill's unknown system: in a world of 1 (NCCL, in
    this process) and of 2 (gloo, spawned, both ranks on this card, every
    message staged through host memory) ``ShardedRegrid`` halo and
    allgather, mean and median at E = 20, bit-equal to the unsharded
    apply of the same weights (each window keeps its entry order);
    ``sharded_cg_solve`` within 10 atol (scipy, float64), one csr_matvec
    launch per iteration and one before; ``sharded_laplace_smooth`` of
    the mesh's faces, 4 steps, equal to a numpy computation (rtol 1e-12)
    and the variance falling.
    16.4 One 16.1 apply (its weights and data) inside ``trace()`` and
    ``annotate("phase16.apply")``, in a process of its own: the trace file
    names the kernel and the region, the result bit-equal to 16.1's.

    Returns (launch counts in this process, largest |kernel - plain|,
    launches in the spawned processes)."""
    import glob
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.core.sparse import MatrixCOO, PaddedCSR
    from xugrid_tpu_torch.parallel import (
        ShardedRegrid,
        hilbert_layout,
        partition_order,
        sharded_cg_solve,
        sharded_laplace_smooth,
    )
    from xugrid_tpu_torch.regrid import ExplicitStructuredGrid3d, StructuredGrid3d, reduce
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.utils.profiling import timings

    t_phase = time.perf_counter()
    kernels = (window_reduce, window_select, csr_matvec)
    max_err = {"window_reduce": 0.0, "window_select": 0.0, "csr_matvec": 0.0}

    def report(line):
        print(f"  {line} [{card}]")

    def uncounted(fn):
        saved = {k: k.launches for k in kernels}
        try:
            return fn()
        finally:
            for k, n in saved.items():
                k.launches = n

    def launches_of(fn):
        before = {k.__name__: k.launches for k in kernels}
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches - before[k.__name__] for k in kernels}

    def kernel_line(label, kernel, source, idx, w, reduction, nnz, lengths=None):
        """Kernel ms (CUDA events, back to back) beside its bound."""
        E, m = source.shape
        n = idx.shape[0]
        ms = uncounted(lambda: cuda_time_ms(lambda: kernel(source, idx, w, reduction)))
        if kernel is window_reduce:
            operations = 2 * nnz * E
        else:
            operations = nnz * E * int(np.ceil(np.log2(max(idx.shape[1], 2))))
        true_bytes = nnz * 8 + m * E * 4 + n * E * 4
        bound, bound_by = bound_ms(true_bytes, operations, "float32", copy_gbps)
        report(
            f"{label} {kernel.__name__} E={E}: {ms:.4f} ms, bound {bound:.4f} ms by {bound_by} "
            f"({100 * bound / ms:.1f} % of it), {true_bytes / (ms * 1e-3) / 1e9:.1f} GB/s true"
        )
        return ms

    (verts, faces), (tverts, tfaces), _ = inputs
    mesh = xt.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    raster_mesh = xt.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    print(f"phase 16: curvilinear and 3-D grids, the sharded regrid and CG, the profiler hooks [{card}]")
    for k in kernels:
        k.launches = 0

    # 16.1: the curvilinear ocean grid onto the 1M mesh.
    rng = np.random.default_rng(16)
    xb, yb, land = ocean_bounds(OCEAN_SIDE, float(N_SIDE), rng)
    values = np.round(rng.normal(size=(N_EXTRA, OCEAN_SIDE, OCEAN_SIDE)) * 2.0) / 2.0
    values = values.astype(np.float32)
    values[rng.random(values.shape) < 0.01] = np.nan
    da = xt.xdata.DataArray(torch.from_numpy(values).to(device), dims=("time", "eta", "xi"), name="sst")
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        uda = xt.UgridDataArray.from_structured2d(da, x="xi", y="eta", x_bounds=xb, y_bounds=yb)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    # The land cells are the only invalid ones the warning counts.
    messages = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    if len(messages) != 1 or f"contain {int(land.sum())} invalid faces" not in messages[0]:
        raise AssertionError(f"16.1 from_structured2d warned {messages}")
    kept = ~land.ravel()
    if uda.grid.n_face != int(kept.sum()) or not isinstance(uda.obj.data, torch.Tensor) or uda.obj.data.device != device:
        raise AssertionError(f"16.1 from_structured2d: {uda.grid.n_face} faces, {type(uda.obj.data).__name__}")
    ocean = values.reshape(N_EXTRA, -1)[:, kept]
    compare(uda.obj.data, torch.from_numpy(ocean), True, 0.0, 0.0)
    areas = uda.grid.area
    if not (areas > 0).all():
        raise AssertionError("16.1: a face of the curvilinear grid has no area")
    report(
        f"16.1 ocean grid {OCEAN_SIDE} x {OCEAN_SIDE} corner bounds, {int(land.sum())} land cells "
        f"({land.mean():.4f}), {uda.grid.n_face} faces, {uda.grid.n_node} nodes; from_structured2d "
        f"{convert_s:.3f} s (data on the card, kept cells bit-equal)"
    )
    scale = float(np.nanmax(np.abs(ocean)))
    sample = np.sort(rng.choice(mesh.n_face, size=400, replace=False))
    ocean_regridders, ocean_out = {}, {}
    for method, kernel in (("mean", window_reduce), ("mode", window_select)):
        timings.reset()
        t0 = time.perf_counter()
        regridder = xt.OverlapRegridder(uda, mesh, method=method)
        build_stages(f"16.1 OverlapRegridder({method}) ocean -> 1M mesh", time.perf_counter() - t0)
        out, rose = launches_of(lambda: regridder.regrid(uda))
        got = out.obj.data
        if tuple(got.shape) != (N_EXTRA, mesh.n_face) or got.device != device:
            raise AssertionError(f"16.1 {method}: {tuple(got.shape)} on {got.device}")
        csr = regridder._weights
        if method == "mean":
            reference = lambda host: (host, reference_linear(csr, ocean, relative=False))  # noqa: E731
        else:
            reference = lambda host: (host[:, sample], reference_select(csr, ocean, sample, "mode"))  # noqa: E731
        max_err[kernel.__name__] = max(max_err[kernel.__name__], check_apply(
            f"16.1 ocean (20, {uda.grid.n_face}) -> 1M mesh by overlap {method}", regridder, uda.obj.data, got,
            kernel, rose, scale, reference,
        ))
        finite = float(torch.isfinite(got).double().mean())
        if finite < 0.8:
            raise AssertionError(f"16.1 {method}: only {finite:.4f} of the mesh faces got a value")
        idx, w = device_weights(regridder._padded, torch.float32, device, regridder._device_weights)
        kernel_line(f"16.1 {method}", kernel, uda.obj.data, idx, w, regridder._reduction, csr.nnz)
        ocean_regridders[method], ocean_out[method] = regridder, got

    # 16.4: one 16.1 apply traced, in a process of its own (``traced_apply``).
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        padded = ocean_regridders["mean"]._padded
        np.savez(os.path.join(tmp, "apply.npz"), indices=padded.indices, weights=padded.weights, n=padded.n,
                 m=padded.m, source=uda.obj.data.cpu().numpy())
        t0 = time.perf_counter()
        run_processes([["--traced-apply", tmp, device]])
        traced_s = time.perf_counter() - t0
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"16.4: trace files {files}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernel_events = [e for e in events if "window_reduce" in e.get("name", "") and e.get("cat") == "kernel"]
        if "phase16.apply" not in names or not kernel_events:
            raise AssertionError(f"16.4: the trace names the region {'phase16.apply' in names}, "
                                 f"the kernel {len(kernel_events)} times")
        traced_launches = int(np.load(os.path.join(tmp, "launches.npy"))[0])
        if traced_launches != 1:
            raise AssertionError(f"16.4: the traced apply launched window_reduce {traced_launches} times")
        compare(torch.from_numpy(np.load(os.path.join(tmp, "applied.npy"))), ocean_out["mean"], True, 0.0, 0.0)
        report(
            f"16.4 trace() of one 16.1 mean apply under annotate('phase16.apply') in a process of its own "
            f"({traced_s:.1f} s with its start): {os.path.getsize(files[0])} bytes, {len(events)} events; kernel "
            f"'{kernel_events[0]['name'][:60]}' {kernel_events[0].get('dur')} us; the result bit-equal to 16.1's"
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 16.2: voxel and layered models.
    nz, ny, nx = VOXEL_SHAPE
    voxels = voxel_dataset(VOXEL_SHAPE, source=True)
    target = StructuredGrid3d(voxel_dataset(VOXEL_TARGET, source=False))
    t_size = target.size
    volume = target.volume.ravel()
    layered_obj = xt.xdata.Dataset(coords={"y": voxels["y"].values, "x": voxels["x"].values})
    layered_obj = layered_obj.assign_coords(
        zbounds=xt.xdata.DataArray(layer_bounds(nz, ny, nx, rng), dims=("layer", "yx", "nbound"))
    )
    for label, grid in (("voxels", StructuredGrid3d(voxels)), ("layered", ExplicitStructuredGrid3d(layered_obj))):
        timings.reset()
        t0 = time.perf_counter()
        s3, t3, w3 = grid.overlap(target, relative=False)
        join_s = time.perf_counter() - t0
        coo = MatrixCOO.from_triplet(t3, s3, w3, n=t_size, m=grid.size)
        t0 = time.perf_counter()
        padded = PaddedCSR.from_coo(coo)
        layout_s = time.perf_counter() - t0
        csr = coo.to_csr()
        # Every target voxel lies inside both models: its weights (overlap
        # volumes) sum to its volume.
        sums = np.bincount(t3, weights=w3, minlength=t_size)
        if not np.allclose(sums, volume, rtol=1e-9, atol=0.0):
            raise AssertionError(f"16.2 {label}: weight sums {sums.min()} .. {sums.max()}, expected {volume[0]}")
        stages = "; ".join(f"{name} {rec['total_s']:.3f} s" for name, rec in timings.summary().items())
        report(
            f"16.2 {label} {grid.shape} -> voxels {target.shape}: overlap {join_s:.3f} s ({stages}), "
            f"PaddedCSR.from_coo {layout_s:.3f} s; nnz {csr.nnz}, w_max {padded.w_max}; every target's weights sum to "
            f"its volume {volume[0]} (1e-9)"
        )
        for n_extra in VOXEL_EXTRAS:
            src_np = rng.normal(size=(n_extra, grid.size)).astype(np.float32)
            src_np[rng.random(src_np.shape) < 0.01] = np.nan
            src = torch.from_numpy(src_np).to(device)
            cache = {}
            got, rose = launches_of(lambda: apply_weights(padded, src, reduce.mean, t_size, plan_cache=cache))
            if rose["window_reduce"] != 1 or sum(rose.values()) != 1:
                raise AssertionError(f"16.2 {label} E={n_extra}: launches {rose}")
            idx, w = device_weights(padded, torch.float32, device, cache)
            plain = reduce.reduce_windows(src.t().contiguous(), idx, w, reduce.mean).t()
            rtol, atol = tolerance(torch.float32, float(np.nanmax(np.abs(src_np))))
            bound = torch.clamp(summation_bound(src, idx, w, reduce.mean), min=atol)
            err = compare(got, plain, False, rtol, bound)
            max_err["window_reduce"] = max(max_err["window_reduce"], err)
            ref_err = compare(got, torch.from_numpy(reference_linear(csr, src_np, relative=False)), False, 1e-5,
                              1e-6 * float(np.nanmax(np.abs(src_np))))
            ms = kernel_line(f"16.2 {label}", window_reduce, src, idx, w, reduce.mean, csr.nnz)
            report(
                f"16.2 {label} mean E={n_extra}: window_reduce +1 launch; vs plain max |diff| {err:.3e}, vs "
                f"reference_linear {ref_err:.3e}; finite {float(torch.isfinite(got).double().mean()):.6f}; {ms:.4f} ms"
            )
            del src, cache
        del s3, t3, w3, coo, csr, padded
        torch.cuda.empty_cache()

    # 16.3: the sharded regrid and CG.
    regridder = next(r for _, method, _, r, *_ in main_results if method == "mean")
    coo = regridder._weights.to_coo()
    t0 = time.perf_counter()
    sorder, torder, hilbert = hilbert_layout(mesh.centroids, raster_mesh.centroids, coo.row, coo.col, coo.data)
    layout_s = time.perf_counter() - t0
    data = inputs[2]
    field_np = np.ascontiguousarray(data[:, sorder])
    field = torch.from_numpy(field_np).to(device)
    median = reduce.ABSOLUTE_OVERLAP_METHODS["median"]
    unsharded = {
        "mean": uncounted(lambda: apply_weights(hilbert, field, reduce.mean, hilbert.n)),
        "median": uncounted(lambda: apply_weights(hilbert, field, median, hilbert.n)),
    }
    report(f"16.3 hilbert_layout of phase 3's mean weights: {layout_s:.3f} s, nnz {coo.nnz}, w_max {hilbert.w_max}")
    if meshes is None:
        nodes, tri = delaunay_mesh(LAPLACE_SIDE)
        grid = xt.Ugrid2d(nodes[:, 0], nodes[:, 1], -1, tri)
        W = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=False).astype(np.float64)
        W.data = np.ones_like(W.data)
        _, fill_values = laplace_inputs(nodes)
        node_xy = nodes
    else:
        W, _, fill_values, _ = meshes["delaunay"]
        node_xy = meshes["delaunay_grid"].node_coordinates
    t0 = time.perf_counter()
    cg_indices, cg_weights, cg_diag, cg_b, A = unknown_system(W, fill_values, node_xy)
    report(f"16.3 the 1M Delaunay fill's unknown system: {len(cg_b)} unknowns, window {cg_indices.shape[1]}, "
           f"Hilbert order, {time.perf_counter() - t0:.3f} s")
    order = partition_order(mesh.centroids)
    remap = np.empty(len(order), np.int64)
    remap[order] = np.arange(len(order))
    neighbors = mesh.format_connectivity_as_dense(mesh.face_face_connectivity)[order]
    neighbors = np.where(neighbors >= 0, remap[np.maximum(neighbors, 0)], -1)
    smooth_values = data[0, order].astype(np.float64)
    smooth_want = smoothing_reference(neighbors, smooth_values, SMOOTH_STEPS)

    def check_cg(label, x, iterations, matvecs):
        residual = np.linalg.norm(A @ x - cg_b)
        if not np.isfinite(x).all() or residual > 10 * LAPLACE_SOLVE["atol"] or matvecs != iterations + 1:
            raise AssertionError(f"16.3 {label} CG: residual {residual}, {iterations} iterations, {matvecs} matvecs")
        return residual

    def check_smooth(label, got):
        compare(torch.from_numpy(got), torch.from_numpy(smooth_want), False, 1e-12, 1e-12)
        if not np.nanvar(got) < np.nanvar(smooth_values):
            raise AssertionError(f"16.3 {label} smoothing: the variance did not fall")

    # World of 1: NCCL in this process.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store1", world_size=1, rank=0)
        try:
            for method in ("halo", "allgather"):
                for label, reduction, kernel in (("mean", reduce.mean, window_reduce), ("median", median, window_select)):
                    sharded = ShardedRegrid(None, hilbert, reduction, method=method, device=device)
                    local = sharded.put_source(field)
                    got, rose = launches_of(lambda: sharded.gather(sharded(local)))
                    if rose[kernel.__name__] != 1 or sum(rose.values()) != 1:
                        raise AssertionError(f"16.3 world 1 {method} {label}: launches {rose}")
                    compare(got, unsharded[label], True, 0.0, 0.0)
                    ms = uncounted(lambda: cuda_time_ms(lambda: sharded(local), reps=5))
                    report(
                        f"16.3 world 1 (nccl) {method} {label} E={N_EXTRA}: {kernel.__name__} +1, bit-equal to the "
                        f"unsharded apply; {ms:.4f} ms per call; exchanged {sharded.exchanged_bytes} bytes per slice"
                    )
            before = csr_matvec.launches
            t0 = time.perf_counter()
            x, k = sharded_cg_solve(None, cg_indices, cg_weights, cg_diag, cg_b, atol=LAPLACE_SOLVE["atol"],
                                    maxiter=LAPLACE_SOLVE["maxiter"], device=device)
            cg_s = time.perf_counter() - t0
            residual = check_cg("world 1", x, k, csr_matvec.launches - before)
            report(f"16.3 world 1 sharded_cg_solve: {k} iterations, {csr_matvec.launches - before} csr_matvec "
                   f"launches (1 per iteration + 1), residual {residual:.3e} <= 10 atol, {cg_s:.3f} s")
            t0 = time.perf_counter()
            smoothed = sharded_laplace_smooth(None, neighbors, smooth_values, n_steps=SMOOTH_STEPS, device=device)
            check_smooth("world 1", smoothed)
            report(f"16.3 world 1 sharded_laplace_smooth {SMOOTH_STEPS} steps: equal to numpy (1e-12), variance "
                   f"{np.nanvar(smooth_values):.4f} -> {np.nanvar(smoothed):.4f}, {time.perf_counter() - t0:.3f} s")
        finally:
            dist.destroy_process_group()

        # World of 2: gloo, spawned, both ranks on this card.
        np.savez(
            os.path.join(tmp, "inputs.npz"), indices=hilbert.indices, weights=hilbert.weights, n=hilbert.n,
            m=hilbert.m, field=field_np, cg_indices=cg_indices, cg_weights=cg_weights, cg_diag=cg_diag, cg_b=cg_b,
            smooth_neighbors=neighbors, smooth_values=smooth_values,
        )
        t0 = time.perf_counter()
        run_processes([["--sharded-rank", rank, SHARDED_WORLD, tmp, device] for rank in range(SHARDED_WORLD)])
        world_s = time.perf_counter() - t0
        ranks = []
        for rank in range(SHARDED_WORLD):
            with np.load(os.path.join(tmp, f"rank{rank}.npz")) as ranked:
                ranks.append(dict(ranked))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for method in ("halo", "allgather"):
        for label in ("mean", "median"):
            compare(torch.from_numpy(ranks[0][f"{method}_{label}"]), unsharded[label], True, 0.0, 0.0)
            numbers = [r[f"{method}_{label}_numbers"] for r in ranks]
            if not all(nums[0] == 1 for nums in numbers):
                raise AssertionError(f"16.3 world 2 {method} {label}: took another method")
            report(
                f"16.3 world 2 (gloo, staged through the host) {method} {label} E={N_EXTRA}: bit-equal to the "
                f"unsharded apply; R {int(numbers[0][2])}, exchanged {int(numbers[0][1])} bytes per slice; ms per "
                f"call by rank {', '.join(f'{nums[3]:.3f}' for nums in numbers)}; staged "
                f"{', '.join(str(int(nums[4])) for nums in numbers)} bytes"
            )
    world2 = {"window_reduce": traced_launches, "window_select": 0, "csr_matvec": 0}
    for r, result in enumerate(ranks):
        iterations, matvecs = (int(v) for v in result["cg_numbers"])
        if r == 0:
            residual = check_cg("world 2", result["cg_x"], iterations, matvecs)
        elif matvecs != iterations + 1:
            raise AssertionError(f"16.3 world 2 rank {r}: {matvecs} matvecs for {iterations} iterations")
        check_smooth(f"world 2 rank {r}", result["smooth"])
        for name, count in zip(world2, result["launches"]):
            world2[name] += int(count)
    report(
        f"16.3 world 2 sharded_cg_solve: {iterations} iterations, {matvecs} csr_matvec launches per rank, residual "
        f"{residual:.3e} <= 10 atol; smoothing equal to numpy on both ranks; the spawned world took {world_s:.1f} s "
        f"(startup included)"
    )
    counts = {k.__name__: k.launches for k in kernels}
    print(
        f"phase 16: {time.perf_counter() - t_phase:.1f} s, launches {counts} in this process, {world2} in the "
        f"spawned ones (16.4's and 16.3's ranks) [{card}]"
    )
    return counts, max_err, world2


BVH_LEAF_SIZE = 8
BVH_POINTS = 1_000_000
BVH_FRONTIER = 8
BVH_BOX_FRONTIER = 16
BVH_NETWORK_POINTS = 100_000
BVH_SEGMENTS = 10_000
#: Operations of one exact test per polygon edge (crossing test and
#: distance to the edge) and per AABB test, as counted for the bounds.
PIP_OPS_PER_EDGE = 25
AABB_OPS = 4


def query_bound(true_bytes, operations, copy_gbps):
    """Phase 17's bound of a query pass: (ms, "bytes" or "operations")."""
    ms, by = bound_ms(true_bytes, operations, "float64", copy_gbps)
    return {"bound_ms": ms, "bound_by": by, "bytes": int(true_bytes), "operations": int(operations)}


def phase_bvh_queries(device, card, copy_gbps, inputs, main_results):
    """Phase 17: the flat BVH and its batched queries (torch ops,
    ``spatial/queries.py``) at full width on the card, each held to the
    port's host computations.

    17.1 ``build_bvh`` over phase 3's 1M face boxes (leaf size 8, 131,072
    leaves) with the native ``kd_order`` and with the numpy branch (host
    seconds; both trees hold every face once), uploaded in float64.
    17.2 ``locate_points_kernel`` of 1,000,000 seeded points (99 % inside
    the mesh's bounds, 1 % outside), the overflowed ones again through
    ``locate_points_while_kernel``, against ``CellTree2d.locate_points``
    (native): every face id equal, but for points within the tolerance of
    an edge, where both faces must hold the point by the native
    ``points_in_polygons``.
    17.3 The 512 x 512 raster's cell boxes through ``box_candidates_kernel``
    and through ``count_box_overlaps_kernel`` then
    ``emit_box_overlaps_kernel`` (capacity the counted maximum): each
    box's faces equal to ``grid_hash.query_boxes`` filtered by the exact
    AABB test, the counts equal to the sets' sizes.
    17.4 ``locate_points_on_edges_kernel`` on phase 7's network for
    100,000 points, half on edges: found and not found as
    ``EdgeCellTree2d.locate_points``, every found edge within the
    tolerance of its point (ties counted).
    17.5 The exact passes against the native host kernels on the same
    pairs: ``points_in_polygons_kernel`` on 17.2's grid-hash candidate
    pairs, ``clip_segments_by_faces_kernel`` on 10,000 cross-sections'
    candidate pairs (``valid`` equal, t0 and t1 within rtol 1e-12),
    ``points_in_triangles_kernel`` on phase 14's burn centroid pairs.
    17.6 ``import xugrid_tpu_torch.plot``; ``uda.ugrid.plot()`` of a CUDA
    payload raises ModuleNotFoundError naming matplotlib where
    matplotlib is not installed, else draws the payload's host copy.

    Times: CUDA events around passes back to back (the passes hold host
    syncs: a descent level's width, the walks' checks), beside the
    native host library's seconds.  Returns (launch counts of the three
    CUDA kernels over the phase, which it does not launch; the timings)."""
    import importlib.util

    import torch

    import xugrid_tpu_torch as xt
    import xugrid_tpu_torch.plot  # noqa: F401  (the card machine has no matplotlib)
    from xugrid_tpu_torch.ops.earcut import earcut_triangulate
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.spatial import build_bvh, queries
    from xugrid_tpu_torch.spatial.bvh import edge_bounding_boxes, face_bounding_boxes
    from xugrid_tpu_torch.spatial.geometry import pad_polygons
    from xugrid_tpu_torch.utils import native

    t_phase = time.perf_counter()
    kernels = (window_reduce, window_select, csr_matvec)
    for k in kernels:
        k.launches = 0
    (verts, faces), (tverts, tfaces), _ = inputs
    mesh = next(r for _, method, _, r, *_ in main_results if method == "mean")._source.ugrid_topology
    rng = np.random.default_rng(17)
    timed = {}

    def report(line):
        print(f"  {line} [{card}]")

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def pass_ms(fn):
        return cuda_time_ms(fn, reps=3, warmup=1, inner=2)

    print(f"phase 17: the flat BVH and its batched queries (torch ops) on the 1M mesh [{card}]")

    # 17.1: the build, native kd order and numpy branch.
    boxes = face_bounding_boxes(faces, verts[:, 0], verts[:, 1])
    host, native_s = host_s(lambda: build_bvh(boxes, BVH_LEAF_SIZE))
    saved = native.kd_order_native
    native.kd_order_native = lambda *args: None
    try:
        numpy_tree, numpy_s = host_s(lambda: build_bvh(boxes, BVH_LEAF_SIZE))
    finally:
        native.kd_order_native = saved
    n_leaves = queries.next_pow2(-(-mesh.n_face // BVH_LEAF_SIZE))
    for label, tree in (("native", host), ("numpy", numpy_tree)):
        held = np.sort(tree.prim_index[tree.prim_index >= 0])
        if tree.n_leaves != n_leaves or not np.array_equal(held, np.arange(mesh.n_face)):
            raise AssertionError(f"17.1 {label} build: {tree.n_leaves} leaves, {len(held)} faces held")
    depth = host.n_leaves.bit_length() - 1
    t0 = time.perf_counter()
    tree = queries.bvh_to_device(host, device=device)
    poly_host = pad_polygons(faces, verts[:, 0], verts[:, 1])
    poly = torch.from_numpy(poly_host).to(device)
    boxes_dev = torch.from_numpy(boxes).to(device)
    torch.cuda.synchronize()
    report(
        f"17.1 build_bvh of {mesh.n_face} face boxes: {host.n_leaves} leaves of {BVH_LEAF_SIZE}, depth {depth}; "
        f"host {native_s:.3f} s with the native kd order, {numpy_s:.3f} s with the numpy branch; "
        f"upload (float64 tree, polygons, boxes) {time.perf_counter() - t0:.3f} s"
    )

    # 17.2: point location, frontier then walk, against the native locate.
    celltree = mesh.celltree
    tol = celltree.default_tolerance()
    n_out = BVH_POINTS // 100
    inside = rng.uniform(0.0, float(N_SIDE), (BVH_POINTS - n_out, 2))
    outside = rng.uniform(1.0, 0.1 * N_SIDE, (n_out, 2)) * rng.choice([-1.0, 1.0], (n_out, 1))
    outside[:, 0] += np.where(outside[:, 0] > 0, float(N_SIDE), 0.0)
    points_host = np.concatenate([inside, outside])
    points = torch.from_numpy(points_host).to(device)
    args = (host.n_internal, BVH_LEAF_SIZE, depth, BVH_FRONTIER, tol)
    found, overflow = queries.locate_points_kernel(points, tree, poly, *args)
    rerun = torch.nonzero(overflow).squeeze(1)
    walk_args = (host.n_internal, BVH_LEAF_SIZE, tol)
    queries._traverse.steps = 0
    found[rerun] = queries.locate_points_while_kernel(points[rerun], tree, poly, *walk_args)
    walk_steps = queries._traverse.steps
    want, locate_s = host_s(lambda: celltree.locate_points(points_host, tol))
    got = found.cpu().numpy()
    differ = np.flatnonzero(got != want)
    if len(differ):
        both = (got[differ] >= 0) & (want[differ] >= 0)
        holds = np.zeros(len(differ), dtype=bool)
        if both.any():
            q = differ[both]
            holds[both] = native.points_in_polygons_native(
                points_host[q], got[q].astype(np.int64), poly_host, tol
            ) & native.points_in_polygons_native(points_host[q], want[q].astype(np.int64), poly_host, tol)
        if not holds.all():
            raise AssertionError(f"17.2 {int((~holds).sum())} point ids differ from the native locate")
    if not ((want[-n_out:] == -1).all() and (got[: BVH_POINTS - n_out] >= 0).all()):
        raise AssertionError("17.2 points inside the mesh must be found and points outside not")
    frontier_ms = pass_ms(lambda: queries.locate_points_kernel(points, tree, poly, *args))
    rerun_ms = pass_ms(lambda: queries.locate_points_while_kernel(points[rerun], tree, poly, *walk_args))
    pair_q, pair_p = celltree.grid_hash.query_points(points_host, tol)
    n_max = poly_host.shape[1]
    node_bytes = host.node_bbox.nbytes + host.prim_index.nbytes
    timed["locate"] = {
        "ms": frontier_ms + rerun_ms, "library_ms": locate_s * 1e3,
        **query_bound(points_host.nbytes + poly_host.nbytes + node_bytes + 4 * BVH_POINTS,
                      BVH_POINTS * depth * 2 * AABB_OPS + len(pair_q) * n_max * PIP_OPS_PER_EDGE, copy_gbps),
    }
    report(
        f"17.2 locate_points_kernel of {BVH_POINTS} points (frontier {BVH_FRONTIER}): {int(overflow.sum())} "
        f"overflowed, rerun through locate_points_while_kernel ({walk_steps} walk steps); equal to "
        f"CellTree2d.locate_points but for {len(differ)} points within the tolerance ({tol:.3e}) of an edge, held "
        f"by both faces; card {frontier_ms:.3f} ms per frontier pass + {rerun_ms:.3f} ms for the rerun, "
        f"{BVH_POINTS / ((frontier_ms + rerun_ms) * 1e-3):.4e} points/s; native locate {locate_s:.4f} s "
        f"({BVH_POINTS / locate_s:.4e} points/s); bound {timed['locate']['bound_ms']:.4f} ms "
        f"({timed['locate']['bound_by']})"
    )

    # 17.3: the raster's cell boxes.
    qboxes_host = face_bounding_boxes(tfaces, tverts[:, 0], tverts[:, 1])
    qboxes = torch.from_numpy(qboxes_host).to(device)
    n_q = len(qboxes_host)
    (ref_q, ref_p), hash_s = host_s(lambda: celltree.grid_hash.query_boxes(qboxes_host))
    b, q = boxes[ref_p], qboxes_host[ref_q]
    exact = (b[:, 0] <= q[:, 2]) & (b[:, 2] >= q[:, 0]) & (b[:, 1] <= q[:, 3]) & (b[:, 3] >= q[:, 1])
    ref_key = np.sort(ref_q[exact] * mesh.n_face + ref_p[exact])
    ref_count = np.bincount(ref_q[exact], minlength=n_q)

    def pair_keys(buffer, rows=None):
        r, c = np.nonzero(buffer >= 0)
        rows = np.arange(len(buffer)) if rows is None else rows
        return np.sort(rows[r].astype(np.int64) * mesh.n_face + buffer[r, c])

    box_args = (host.n_internal, BVH_LEAF_SIZE)
    cands, box_overflow = queries.box_candidates_kernel(qboxes, tree, boxes_dev, *box_args, depth, BVH_BOX_FRONTIER)
    kept = np.flatnonzero(~box_overflow.cpu().numpy())
    kept_keys = pair_keys(cands.cpu().numpy()[kept], kept)
    if not np.array_equal(kept_keys, ref_key[np.isin(ref_key // mesh.n_face, kept)]):
        raise AssertionError("17.3 box_candidates_kernel's sets differ from the grid hash's")
    queries._traverse.steps = 0
    counts = queries.count_box_overlaps_kernel(qboxes, tree, boxes_dev, *box_args)
    count_steps = queries._traverse.steps
    capacity = int(counts.max())
    out, emitted = queries.emit_box_overlaps_kernel(qboxes, tree, boxes_dev, *box_args, capacity)
    if not (np.array_equal(counts.cpu().numpy(), ref_count) and np.array_equal(emitted.cpu().numpy(), ref_count)):
        raise AssertionError("17.3 counts differ from the grid hash's set sizes")
    if not np.array_equal(pair_keys(out.cpu().numpy()), ref_key):
        raise AssertionError("17.3 emit_box_overlaps_kernel's sets differ from the grid hash's")
    candidates_ms = pass_ms(
        lambda: queries.box_candidates_kernel(qboxes, tree, boxes_dev, *box_args, depth, BVH_BOX_FRONTIER)
    )
    count_ms = pass_ms(lambda: queries.count_box_overlaps_kernel(qboxes, tree, boxes_dev, *box_args))
    emit_ms = pass_ms(lambda: queries.emit_box_overlaps_kernel(qboxes, tree, boxes_dev, *box_args, capacity))
    box_bytes = qboxes_host.nbytes + boxes.nbytes + node_bytes + 4 * len(ref_key)
    box_ops = n_q * depth * 2 * AABB_OPS + len(ref_q) * AABB_OPS
    timed["boxes"] = {
        "ms": count_ms + emit_ms, "library_ms": hash_s * 1e3,
        **query_bound(box_bytes, box_ops, copy_gbps),
    }
    report(
        f"17.3 {n_q} raster cell boxes, {len(ref_key)} (box, face) pairs, at most {capacity} per box: "
        f"box_candidates_kernel (frontier {BVH_BOX_FRONTIER}) {candidates_ms:.3f} ms, "
        f"{int(box_overflow.sum())} overflowed, the rest equal to the grid hash; count_box_overlaps_kernel "
        f"{count_ms:.3f} ms ({count_steps} walk steps), emit_box_overlaps_kernel {emit_ms:.3f} ms, both equal; "
        f"grid_hash.query_boxes {hash_s:.4f} s; bound {timed['boxes']['bound_ms']:.4f} ms ({timed['boxes']['bound_by']})"
    )

    # 17.4: points on the network's edges.
    network, _ = phase7_network()
    edges_tree = network.celltree
    edge_xy_host = network.node_coordinates[network.edge_node_connectivity]
    edge_host = build_bvh(edge_bounding_boxes(network.edge_node_connectivity, *network.node_coordinates.T), BVH_LEAF_SIZE)
    edge_tree = queries.bvh_to_device(edge_host, device=device)
    edge_xy = torch.from_numpy(edge_xy_host).to(device)
    half = BVH_NETWORK_POINTS // 2
    pick = rng.integers(0, network.n_edge, half)
    t = rng.uniform(0.0, 1.0, (half, 1))
    net_points_host = np.concatenate([
        edge_xy_host[pick, 0] + t * (edge_xy_host[pick, 1] - edge_xy_host[pick, 0]),
        rng.uniform(0.0, float(N_SIDE), (half, 2)),
    ])
    net_points = torch.from_numpy(net_points_host).to(device)
    edge_tol = edges_tree.default_tolerance()
    edge_depth = edge_host.n_leaves.bit_length() - 1
    frontier = BVH_FRONTIER
    while True:
        edge_args = (edge_host.n_internal, BVH_LEAF_SIZE, edge_depth, frontier, edge_tol)
        on_edge, edge_overflow = queries.locate_points_on_edges_kernel(net_points, edge_tree, edge_xy, *edge_args)
        if not bool(edge_overflow.any()):
            break
        frontier *= 4
    on_host, edge_s = host_s(lambda: edges_tree.locate_points(net_points_host, edge_tol))
    got_edges = on_edge.cpu().numpy()
    if not np.array_equal(got_edges >= 0, on_host >= 0):
        raise AssertionError("17.4 found and not found differ from EdgeCellTree2d.locate_points")
    hit = np.flatnonzero(got_edges >= 0)
    seg = edge_xy_host[got_edges[hit]]
    d = seg[:, 1] - seg[:, 0]
    tt = np.clip(((net_points_host[hit] - seg[:, 0]) * d).sum(axis=1) / np.maximum((d * d).sum(axis=1), 1e-300), 0.0, 1.0)
    dist2 = ((net_points_host[hit] - (seg[:, 0] + tt[:, None] * d)) ** 2).sum(axis=1)
    if not (dist2 <= edge_tol * edge_tol).all():
        raise AssertionError("17.4 a found edge lies beyond the tolerance of its point")
    edge_ms = pass_ms(lambda: queries.locate_points_on_edges_kernel(net_points, edge_tree, edge_xy, *edge_args))
    edge_pairs = edges_tree.grid_hash.query_boxes(np.column_stack([net_points_host - edge_tol, net_points_host + edge_tol]))[0]
    timed["network"] = {
        "ms": edge_ms, "library_ms": edge_s * 1e3,
        **query_bound(net_points_host.nbytes + edge_xy_host.nbytes + edge_host.node_bbox.nbytes
                      + edge_host.prim_index.nbytes + 4 * BVH_NETWORK_POINTS,
                      BVH_NETWORK_POINTS * edge_depth * 2 * AABB_OPS + len(edge_pairs) * PIP_OPS_PER_EDGE, copy_gbps),
    }
    report(
        f"17.4 locate_points_on_edges_kernel of {BVH_NETWORK_POINTS} points ({half} on edges) on {network.n_edge} "
        f"edges (frontier {frontier}): {len(hit)} found as EdgeCellTree2d.locate_points, "
        f"{int((got_edges[hit] != on_host[hit]).sum())} on another edge within the tolerance (ties); card "
        f"{edge_ms:.3f} ms ({BVH_NETWORK_POINTS / (edge_ms * 1e-3):.4e} points/s), EdgeCellTree2d {edge_s:.4f} s; "
        f"bound {timed['network']['bound_ms']:.4f} ms ({timed['network']['bound_by']})"
    )

    # 17.5: the exact passes against the native host kernels.
    pip_points = torch.from_numpy(points_host[pair_q]).to(device)
    pip_faces = torch.from_numpy(pair_p).to(device)
    pip = queries.points_in_polygons_kernel(pip_points, pip_faces, poly, tol)
    pip_want, pip_s = host_s(lambda: native.points_in_polygons_native(points_host[pair_q], pair_p, poly_host, tol))
    if not np.array_equal(pip.cpu().numpy(), pip_want):
        raise AssertionError("17.5 points_in_polygons_kernel differs from the native kernel")
    pip_ms = pass_ms(lambda: queries.points_in_polygons_kernel(pip_points, pip_faces, poly, tol))

    start = rng.uniform(0.0, float(N_SIDE), (BVH_SEGMENTS, 2))
    angle = rng.uniform(-np.pi, np.pi, BVH_SEGMENTS)
    length = rng.uniform(2.0, 30.0, (BVH_SEGMENTS, 1))
    sections = np.stack([start, start + length * np.column_stack([np.cos(angle), np.sin(angle)])], axis=1)
    seg_boxes = np.concatenate([sections.min(axis=1), sections.max(axis=1)], axis=1)
    seg_q, seg_p = celltree.grid_hash.query_boxes(seg_boxes)
    p0, p1 = sections[seg_q, 0], sections[seg_q, 1]
    p0_dev, p1_dev = torch.from_numpy(p0).to(device), torch.from_numpy(p1).to(device)
    seg_faces = torch.from_numpy(seg_p[:, None]).to(device)
    valid, t0, t1 = queries.clip_segments_by_faces_kernel(p0_dev, p1_dev, seg_faces, poly)
    (want_valid, want_t0, want_t1), clip_s = host_s(
        lambda: native.clip_segments_by_faces_native(p0, p1, seg_p, poly_host)
    )
    valid = valid[:, 0].cpu().numpy()
    if not np.array_equal(valid, want_valid):
        raise AssertionError(f"17.5 clip valid differs on {int((valid != want_valid).sum())} pairs")
    clip_err = 0.0
    for got_t, want_t in ((t0, want_t0), (t1, want_t1)):
        got_t = got_t[:, 0].cpu().numpy()[valid]
        np.testing.assert_allclose(got_t, want_t[valid], rtol=1e-12, atol=0.0, err_msg="17.5 clip t")
        clip_err = max(clip_err, float(np.abs(got_t - want_t[valid]).max(initial=0.0)))
    clip_ms = pass_ms(lambda: queries.clip_segments_by_faces_kernel(p0_dev, p1_dev, seg_faces, poly))

    # Phase 14 put shapely (or its stand-in) in sys.modules.
    shp = sys.modules.get("shapely") or geometry_modules()[0]
    scale = float(N_SIDE) / 300e3
    rings = [shp.get_coordinates(p.exterior)[:-1] * scale for p in xt.data.provinces_nl().geometry]
    tri_xy, tri_index, centroid_face = [], [], []
    n_tri = 0
    for ring in rings:
        triangles = earcut_triangulate(ring, np.array([len(ring)]))
        t_idx, g_idx, _ = celltree.intersect_faces(ring, triangles, -1)
        tri_xy.append(ring[triangles])
        tri_index.append(t_idx + n_tri)
        centroid_face.append(g_idx)
        n_tri += len(triangles)
    tri_xy, tri_index, centroid_face = np.concatenate(tri_xy), np.concatenate(tri_index), np.concatenate(centroid_face)
    centroids = mesh.centroids[centroid_face]
    c_dev, ti_dev, tri_dev = (torch.from_numpy(a).to(device) for a in (centroids, tri_index, tri_xy))
    in_tri = queries.points_in_triangles_kernel(c_dev, ti_dev, tri_dev, tol)
    tri_want, tri_s = host_s(lambda: native.points_in_polygons_native(centroids, tri_index.astype(np.int64), tri_xy, tol))
    if not np.array_equal(in_tri.cpu().numpy(), tri_want):
        raise AssertionError("17.5 points_in_triangles_kernel differs from the native kernel")
    tri_ms = pass_ms(lambda: queries.points_in_triangles_kernel(c_dev, ti_dev, tri_dev, tol))
    exact_bytes = {
        "pip": 24 * len(pair_q) + poly_host.nbytes + len(pair_q),
        "clip": 40 * len(seg_q) + poly_host.nbytes + 17 * len(seg_q),
        "tri": 24 * len(tri_index) + tri_xy.nbytes + len(tri_index),
    }
    for key, pairs, ms, lib_s, per_pair in (
        ("pip", len(pair_q), pip_ms, pip_s, n_max * PIP_OPS_PER_EDGE),
        ("clip", len(seg_q), clip_ms, clip_s, n_max * PIP_OPS_PER_EDGE),
        ("tri", len(tri_index), tri_ms, tri_s, 3 * PIP_OPS_PER_EDGE),
    ):
        timed[key] = {"ms": ms, "library_ms": lib_s * 1e3, "pairs": pairs,
                      **query_bound(exact_bytes[key], pairs * per_pair, copy_gbps)}
    report(
        f"17.5 exact passes, equal to the native kernels: points_in_polygons_kernel {len(pair_q)} pairs "
        f"{pip_ms:.3f} ms ({len(pair_q) / (pip_ms * 1e-3):.4e} pairs/s; native {len(pair_q) / pip_s:.4e}); "
        f"clip_segments_by_faces_kernel {len(seg_q)} pairs of {BVH_SEGMENTS} cross-sections, {int(valid.sum())} "
        f"valid, max |t - native| {clip_err:.3e}, {clip_ms:.3f} ms ({len(seg_q) / (clip_ms * 1e-3):.4e} pairs/s; "
        f"native {len(seg_q) / clip_s:.4e}); points_in_triangles_kernel {len(tri_index)} burn centroid pairs "
        f"{tri_ms:.3f} ms ({len(tri_index) / (tri_ms * 1e-3):.4e} pairs/s; native {len(tri_index) / tri_s:.4e})"
    )
    for key in ("pip", "clip", "tri"):
        report(f"    {key}: bound {timed[key]['bound_ms']:.4f} ms ({timed[key]['bound_by']})")

    # 17.6: plotting on the card machine.
    small_v, small_f = quad_mesh(10, 10)
    small = xt.Ugrid2d(small_v[:, 0], small_v[:, 1], -1, small_f)
    payload = torch.arange(float(small.n_face), device=device)
    uda = xt.UgridDataArray(xt.xdata.DataArray(payload, dims=(small.face_dimension,)), small)
    if importlib.util.find_spec("matplotlib") is None:
        try:
            uda.ugrid.plot()
        except ModuleNotFoundError as error:
            if "matplotlib" not in str(error):
                raise
        else:
            raise AssertionError("17.6 plot() without matplotlib did not raise")
        report("17.6 xugrid_tpu_torch.plot imports; uda.ugrid.plot() of a CUDA payload raises ModuleNotFoundError "
               "(no matplotlib here): the drawing runs only in the CPU tests")
    else:
        import matplotlib

        matplotlib.use("Agg")
        artist = uda.ugrid.plot()
        if not np.array_equal(np.asarray(artist.get_array()), payload.cpu().numpy()):
            raise AssertionError("17.6 the drawn array differs from the payload's host copy")
        report("17.6 matplotlib is installed here: uda.ugrid.plot() drew the CUDA payload's host copy")
    counts = {k.__name__: k.launches for k in kernels}
    if any(counts.values()):
        raise AssertionError(f"17: the BVH queries launched CUDA kernels {counts}")
    report(f"phase 17 done in {time.perf_counter() - t_phase:.1f} s; CUDA kernel launches {counts}")
    return counts, timed


def same_tessellation(label, got, want):
    """Hold a voronoi_topology result to another: vertices, face map
    and interpolation map equal, each polygon row equal or, where an
    angle tie sorted two vertices apart, the same vertices.  Returns the
    count of such rows."""
    for name, a, b in zip(("vertices", "faces", "face_index", "interpolation_map"), got, want):
        if (a is None) != (b is None) or (a is not None and a.shape != b.shape):
            raise AssertionError(f"{label}: {name} differs in shape")
        if a is not None and name != "faces" and not np.array_equal(a, b):
            raise AssertionError(f"{label}: {name} differs")
    rows = np.flatnonzero((got[1] != want[1]).any(axis=1))
    for r in rows:
        if not np.array_equal(np.sort(got[1][r]), np.sort(want[1][r])):
            raise AssertionError(f"{label}: polygon {r} differs in its vertices")
    return len(rows)


def phase_jax_forms(device, card, results, meshes):
    """Phase 18: calls in the JAX package's form through the port's entry
    points, with no ``device=``, at the 1M config: ``apply_weights`` with
    its positional ``dtype`` on an int32 source, the Delaunay Laplace
    fill with every parameter by position (``delta`` and ``relax`` at 6
    and 7), ``UnstructuredGrid2d.barycentric`` and ``voronoi_topology``.
    Each is held to the keyword or ``device="cpu"`` form of the same
    call after the counts are read."""
    import torch

    from xugrid_tpu_torch.regrid import reduce, unstructured
    from xugrid_tpu_torch.regrid.aligned_apply import csr_matvec, window_reduce
    from xugrid_tpu_torch.regrid.apply import apply_weights, device_weights
    from xugrid_tpu_torch.regrid.select_apply import window_select
    from xugrid_tpu_torch.ugrid import interpolate, voronoi

    def report(line):
        print(f"  {line} [{card}]")

    t_phase = time.perf_counter()
    print(f"phase 18: the JAX package's call forms with no device= at the 1M config [{card}]")
    kernels = (window_reduce, window_select, csr_matvec)
    regridder = next(r for _, method, _, r, *_ in results if method == "mean")
    padded, n = regridder._padded, regridder._padded.n
    generator = torch.Generator(device=device).manual_seed(18)
    source = torch.randint(-50, 51, (N_EXTRA, padded.m), generator=generator, device=device, dtype=torch.int32)
    W, labels, values, _ = meshes["delaunay"]
    solve = (LAPLACE_SOLVE["rtol"], LAPLACE_SOLVE["atol"], LAPLACE_SOLVE["maxiter"], 4)
    mesh, raster = regridder._source.ugrid_topology, regridder._target.ugrid_topology
    topology = (
        mesh.node_face_connectivity, mesh.node_coordinates, mesh.centroids, mesh.edge_face_connectivity,
        mesh.edge_node_connectivity, True, True, True,
    )
    source_adapter, target_adapter = unstructured.UnstructuredGrid2d(raster), unstructured.UnstructuredGrid2d(mesh)
    # Record the device every resolve_device on these paths hands back.
    resolved = []
    originals = {module: module.resolve_device for module in (unstructured, voronoi, interpolate)}

    def recording(original):
        def resolve(data=None, device=None):
            out = original(data, device)
            resolved.append(out)
            return out

        return resolve

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    try:
        for module, original in originals.items():
            module.resolve_device = recording(original)
        t0 = time.perf_counter()
        jax_apply = apply_weights(padded, source, reduce.mean, n, np.float32)
        torch.cuda.synchronize()
        apply_counts = {k.__name__: k.launches for k in kernels}
        t1 = time.perf_counter()
        jax_fill = interpolate.laplace_interpolate(values, W, True, labels, False, 0.5, 0.9, *solve)
        fill_info = dict(interpolate.last_solve_info)
        fill_devices = list(resolved)
        t2 = time.perf_counter()
        jax_bary = source_adapter.barycentric(target_adapter)
        bary_devices = resolved[len(fill_devices):]
        t3 = time.perf_counter()
        jax_voronoi = voronoi.voronoi_topology(*topology)
        voronoi_devices = resolved[len(fill_devices) + len(bary_devices):]
        t4 = time.perf_counter()
    finally:
        for module, original in originals.items():
            module.resolve_device = original
    counts = {k.__name__: k.launches for k in kernels}

    # 18.1: one window_reduce launch; bit-equal to the keyword call on the
    # source cast by hand, and within the float32 tolerance of the plain
    # version.
    if apply_counts != {"window_reduce": 1, "window_select": 0, "csr_matvec": 0}:
        raise AssertionError(f"18.1 apply_weights(w, int32 source, mean, n, np.float32) launched {apply_counts}")
    if jax_apply.dtype != torch.float32 or tuple(jax_apply.shape) != (N_EXTRA, n) or jax_apply.device != source.device:
        raise AssertionError(f"18.1 result {jax_apply.dtype} {tuple(jax_apply.shape)} on {jax_apply.device}")
    cast = source.to(torch.float32)
    by_keyword = apply_weights(padded, cast, reduce.mean, n, plan_cache=regridder._device_weights)
    compare(jax_apply, by_keyword, True, 0.0, 0.0)
    idx, w = device_weights(padded, torch.float32, source.device, regridder._device_weights)
    plain = reduce.reduce_windows(cast.t().contiguous(), idx, w, reduce.mean).t()
    rtol, atol = tolerance(torch.float32, 50.0)
    apply_err = compare(jax_apply, plain, False, rtol, atol)
    report(
        f"18.1 apply_weights(padded, int32 source ({N_EXTRA}, {padded.m}) on the card, reduce.mean, n, np.float32): "
        f"window_reduce +1 launch, float32 ({N_EXTRA}, {n}) on the card, bit-equal to the call on the source cast "
        f"by hand, vs plain max |diff| {apply_err:.3e} (rtol {rtol:g}, atol {atol:g}); {t1 - t0:.3f} s"
    )

    # 18.2: the positional fill launches csr_matvec as phase 5 counts it
    # and gives the keyword call's bits.
    expected = 4 + fill_info["iterations"] * 4
    if counts["csr_matvec"] != expected:
        raise AssertionError(f"18.2 the positional fill launched csr_matvec {counts['csr_matvec']} times, not {expected}")
    if not fill_devices or any(d.type != "cuda" for d in fill_devices):
        raise AssertionError(f"18.2 the positional fill resolved {fill_devices}")
    by_keyword = interpolate.laplace_interpolate(values, W, components_labels=labels, precondition_degree=4, **LAPLACE_SOLVE)
    if not np.array_equal(jax_fill, by_keyword, equal_nan=True):
        raise AssertionError(
            f"18.2 the positional fill differs from the keyword call by {np.nanmax(np.abs(jax_fill - by_keyword))}"
        )
    report(
        f"18.2 laplace_interpolate(values, W, True, labels, False, 0.5, 0.9, rtol, atol, maxiter, 4) on the "
        f"{len(values)}-node Delaunay mesh: {fill_info['iterations']} iterations on {fill_devices[0]}, csr_matvec "
        f"+{counts['csr_matvec']} launches, bit-equal to the keyword call without delta and relax; {t2 - t1:.3f} s"
    )

    # 18.3 and 18.4: the device resolved is the card's, and the result is
    # the one sorted on the CPU.
    for label, devices in (("18.3 barycentric", bary_devices), ("18.4 voronoi_topology", voronoi_devices)):
        if not devices or any(d.type != "cuda" for d in devices):
            raise AssertionError(f"{label} with no device resolved {devices}")
    t5 = time.perf_counter()
    on_cpu = source_adapter.barycentric(target_adapter, device="cpu")
    t6 = time.perf_counter()
    order, cpu_order = np.lexsort(jax_bary[1::-1]), np.lexsort(on_cpu[1::-1])
    for k in range(2):
        if not np.array_equal(jax_bary[k][order], on_cpu[k][cpu_order]):
            raise AssertionError("18.3 barycentric on the card and on the CPU differ in their triplets' indices")
    weight_diff = float(np.max(np.abs(jax_bary[2][order] - on_cpu[2][cpu_order]) / np.abs(on_cpu[2][cpu_order])))
    if weight_diff > 1e-12:
        raise AssertionError(f"18.3 barycentric weights on the card and on the CPU differ by rtol {weight_diff:.3e}")
    report(
        f"18.3 UnstructuredGrid2d(raster {raster.n_face} faces).barycentric(mesh {mesh.n_face} faces) with no device: "
        f"resolved {bary_devices[0]}, {len(jax_bary[2])} triplets, equal to device='cpu' (weights within rtol "
        f"{weight_diff:.3e}); {t3 - t2:.3f} s on the card, {t6 - t5:.3f} s with device='cpu'"
    )
    t7 = time.perf_counter()
    on_cpu = voronoi.voronoi_topology(*topology, device="cpu")
    t8 = time.perf_counter()
    ties = same_tessellation("18.4 voronoi_topology", jax_voronoi, on_cpu)
    report(
        f"18.4 voronoi_topology(the 1M mesh's node_face, nodes, centroids, edge_face, edge_node, True, True, True) "
        f"with no device: the angle sort on {voronoi_devices[0]}, {len(jax_voronoi[1])} polygons, "
        f"{len(jax_voronoi[0])} vertices, equal to device='cpu' but {ties} rows of angle ties; "
        f"{t4 - t3:.3f} s on the card, {t8 - t7:.3f} s with device='cpu'"
    )
    report(f"phase 18 done in {time.perf_counter() - t_phase:.1f} s; CUDA kernel launches {counts}")
    return counts, {"window_reduce": apply_err, "csr_matvec": 0.0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import xugrid_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if sys.argv[1:2] == ["--sharded-rank"]:
        return sharded_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--traced-apply"]:
        return traced_apply(sys.argv[2:])
    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    t_start = time.perf_counter()
    log = phase_build()
    if sys.argv[1:2] == ["--compare"]:
        phase_compare(device, card, sys.argv[2])
        print(f"chip_smoke --compare {sys.argv[2]}: done in {time.perf_counter() - t_start:.1f} s")
        return 0
    check_select_registers(log)
    reduce_registers = check_reduce_registers(log)
    check_err = phase_kernel_checks(device)
    check_err["csr_matvec"] = phase_matvec_checks(device)
    counts, main_err, results, inputs = phase_main_path(device)
    report_main_path_builds(reduce_registers, results[0][3]._padded.w_max)
    timed, copy_gbps = phase_timing(device, results, card)
    laplace_counts, _, meshes = phase_laplace(device)
    matvec_timed = phase_laplace_timing(device, card, copy_gbps, meshes)
    main_matvec = matvec_timed[("float64", 1)]
    regrid_counts, regrid_err, _ = phase_regridders(device, card, inputs)
    labelled_counts, labelled_err, _ = phase_labelled(device, card, inputs, meshes)
    files_counts, files_err = phase_files(device, card, inputs, timed)
    partition_counts, partition_err = phase_partitions(device, card, inputs, results)
    query_counts, query_err, _ = phase_queries(device, card, inputs)
    topology_counts, topology_err = phase_topology(device, card, inputs, results)
    payload_counts, payload_err, payload = phase_payload(device, card, inputs, results)
    vector_counts, vector_err = phase_vector(device, card, inputs, results, payload)
    stream_counts, stream_err, timed_10m = phase_stream(device, card, copy_gbps, results, payload)
    slice16_counts, slice16_err, world2_counts = phase_structured_sharded(
        device, card, copy_gbps, inputs, results, meshes
    )
    phase16_label = "curvilinear and 3-D grids, sharded regrid and CG in worlds of 1 and 2, profiler hooks (phase 16)"
    bvh_counts, _ = phase_bvh_queries(device, card, copy_gbps, inputs, results)
    phase17_label = "the flat BVH and its batched queries as torch ops (phase 17)"
    jax_form_counts, jax_form_err = phase_jax_forms(device, card, results, meshes)
    phase18_label = "the JAX package's call forms with no device= (phase 18)"

    def window_entry(name, timed_at):
        """A window kernel's line: launches summed over the paths that
        launch it (each counted from 0 over its own run)."""
        by_path = {
            "overlap regridders (phase 3)": counts[name],
            "phase 7 regridders": regrid_counts[name],
            "labelled arrays and structured grids (phase 8)": labelled_counts[name],
            "UGRID files and stored weights (phase 9)": files_counts[name],
            "merge_partitions then regrid (phase 10)": partition_counts[name],
            "queries and the nearest fill, then regrid (phase 11)": query_counts[name],
            "topology operations, then regrid and fill (phase 12)": topology_counts[name],
            "payload methods, then regrid and fill (phase 13)": payload_counts[name],
            "vector geometry and sample data, then regrid and fill (phase 14)": vector_counts[name],
            "the XL config streamed from files, grouped methods, then regrid (phase 15)": stream_counts[name],
            phase16_label: slice16_counts[name] + world2_counts[name],
            phase17_label: bvh_counts[name],
            phase18_label: jax_form_counts[name],
        }
        return {
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(
                check_err[name], main_err[name], regrid_err[name], labelled_err[name], files_err[name],
                partition_err[name], query_err.get(name, 0.0), topology_err[name], payload_err[name],
                vector_err[name], stream_err[name], slice16_err[name], jax_form_err.get(name, 0.0),
            ),
            **timed_at,
        }

    matvec_by_path = {
        "Laplace fill (phase 5)": laplace_counts["csr_matvec"],
        "labelled arrays and structured grids (phase 8)": labelled_counts["csr_matvec"],
        "topology operations, then regrid and fill (phase 12)": topology_counts["csr_matvec"],
        "payload methods, then regrid and fill (phase 13)": payload_counts["csr_matvec"],
        "vector geometry and sample data, then regrid and fill (phase 14)": vector_counts["csr_matvec"],
        phase16_label: slice16_counts["csr_matvec"] + world2_counts["csr_matvec"],
        phase17_label: bvh_counts["csr_matvec"],
        phase18_label: jax_form_counts["csr_matvec"],
    }

    kernels = [
        {
            "name": "window_reduce",
            "route": "cuda",
            "source": "xugrid_tpu_torch/csrc/window_reduce.cu",
            "replaces": "xugrid_tpu/regrid/aligned_apply.py:1271",
            **window_entry("window_reduce", timed[("mean", N_EXTRA)]),
            "at_10M": {"E": N_EXTRA, **timed_10m["mean"]},
        },
        {
            "name": "window_select",
            "route": "cuda",
            "source": "xugrid_tpu_torch/csrc/window_select.cu",
            "replaces": "xugrid_tpu/regrid/select_apply.py:804",
            **window_entry("window_select", timed[("median", N_EXTRA)]),
            "at_10M": {"E": N_EXTRA, **timed_10m["median"]},
        },
        {
            "name": "csr_matvec",
            "route": "cuda",
            "source": "xugrid_tpu_torch/csrc/window_reduce.cu",
            "replaces": (
                "xugrid_tpu/regrid/aligned_apply.py:1271 (matvec); "
                "xugrid_tpu/regrid/gather_apply.py:1794, 1858, 1413, 975"
            ),
            "launches": sum(matvec_by_path.values()),
            "launches_by_path": matvec_by_path,
            **main_matvec,
            "max_abs_err": max(
                check_err["csr_matvec"], topology_err["csr_matvec"], payload_err["csr_matvec"], vector_err["csr_matvec"],
                slice16_err["csr_matvec"],
                *(t["max_abs_err"] for t in matvec_timed.values()),
            ),
        },
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
