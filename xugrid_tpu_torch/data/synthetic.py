"""
Sample datasets (host, numpy and scipy).

Each loader reads upstream xugrid's published file when it lies in
``XUGRID_DATA_DIR`` (``data/registry.py``), else generates a
deterministic synthetic stand-in of the same structure: the same
facets, dimensionality and rough scale.  ``disk()`` is upstream's
synthetic disk: a triangulated unit circle scaled to [0, 10] with an
analytic surface on nodes, edges and faces.  Copied from
``xugrid_tpu/data/synthetic.py``, so both packages give the same arrays.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu_torch import xdata


def transform(vertices, minx, maxx, miny):
    """Rescale vertices into [minx, maxx], preserving aspect ratio."""
    x, y = vertices.T
    xmin, xmax = x.min(), x.max()
    ymin, ymax = y.min(), y.max()
    dx = xmax - xmin
    dy = ymax - ymin
    new_dx = maxx - minx
    new_dy = dy / dx * new_dx
    x = (x - xmin) * new_dx / dx + minx
    y = (y - ymin) * new_dy / dy + miny
    return np.column_stack([x, y])


def generate_disk(partitions: int, depth: int):
    """
    Triangular mesh of the unit circle: ``partitions`` triangles around
    the origin, ``depth`` concentric layers.

    Returns (vertices (n, 2), triangles (m, 3)).
    """
    import matplotlib.tri

    if partitions < 3:
        raise ValueError("partitions should be >= 3")
    N = depth + 1
    n_per_level = partitions * np.arange(N)
    n_per_level[0] = 1

    delta_angle = (2 * np.pi) / np.repeat(n_per_level, n_per_level)
    index = np.repeat(np.insert(n_per_level.cumsum()[:-1], 0, 0), n_per_level)
    angles = delta_angle.cumsum()
    angles = angles - angles[index] + 0.5 * np.pi
    radii = np.repeat(np.linspace(0.0, 1.0, N), n_per_level)

    x = np.cos(angles) * radii
    y = np.sin(angles) * radii
    triang = matplotlib.tri.Triangulation(x, y)
    return np.column_stack((x, y)), triang.triangles


def _disk_z(x, y):
    """A smooth surface with two interacting lobes (tricontour demo)."""
    r1 = np.sqrt((0.5 - x) ** 2 + (0.5 - y) ** 2)
    theta1 = np.arctan2(0.5 - x, 0.5 - y)
    r2 = np.sqrt((-x - 0.2) ** 2 + (-y - 0.2) ** 2)
    theta2 = np.arctan2(-x - 0.2, -y - 0.2)
    z = -(
        2 * (np.exp((r1 / 10) ** 2) - 1) * 30.0 * np.cos(7.0 * theta1)
        + (np.exp((r2 / 10) ** 2) - 1) * 30.0 * np.cos(11.0 * theta2)
        + 0.7 * (x**2 + y**2)
    )
    zmin = z.min()
    zmax = z.max()
    return (zmax - z) / (zmax - zmin) * 10.0


def _load_real_ugrid(filename: str):
    """Open a registered real sample file as a UgridDataset, or None
    (absent, or an unreadable format — e.g. netCDF4/HDF5, which the
    scipy NetCDF3 backend cannot parse)."""
    import warnings

    import xugrid_tpu_torch as xu
    from xugrid_tpu_torch.data.registry import fetch

    path = fetch(filename)
    if path is None:
        return None
    try:
        return xu.open_dataset(path)
    except Exception as exc:  # pragma: no cover - depends on local files
        warnings.warn(
            f"Could not read sample file {path} ({exc}); "
            "using the synthetic stand-in instead."
        )
        return None


def disk():
    """Triangulated disk with analytic data on nodes, edges, and faces."""
    import xugrid_tpu_torch as xu

    vertices, triangles = generate_disk(6, 8)
    vertices = transform(vertices, 0.0, 10.0, 0.0)
    grid = xu.Ugrid2d(vertices[:, 0], vertices[:, 1], -1, triangles)

    ds = xdata.Dataset()
    ds["node_z"] = ((grid.node_dimension,), _disk_z(*grid.node_coordinates.T))
    ds["face_z"] = ((grid.face_dimension,), _disk_z(*grid.face_coordinates.T))
    ds["edge_z"] = ((grid.edge_dimension,), _disk_z(*grid.edge_coordinates.T))
    return xu.UgridDataset(ds, [grid])


def elevation_nl(n_points: int = 26000, seed: int = 0):
    """
    The elevation_nl sample (~52k-face triangular national elevation
    mesh): loads upstream xugrid's published elevation_nl.nc when present
    in XUGRID_DATA_DIR (xugrid/data/sample_data.py:47-59), else a
    synthetic Delaunay stand-in over a national-outline-like domain.
    """
    import xugrid_tpu_torch as xu
    from scipy.spatial import Delaunay

    real = _load_real_ugrid("elevation_nl.nc")
    if real is not None:
        return real["elevation"]

    rng = np.random.default_rng(seed)
    # An irregular blobby domain ~ 250x300 km.
    pts = rng.uniform([0.0, 0.0], [250e3, 300e3], (n_points, 2))
    cx, cy = 125e3, 150e3
    angle = np.arctan2(pts[:, 1] - cy, pts[:, 0] - cx)
    radius = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
    boundary = (1.0 + 0.25 * np.sin(3 * angle) + 0.15 * np.cos(5 * angle)) * 140e3
    keep = radius < boundary
    pts = pts[keep]
    tri = Delaunay(pts)
    grid = xu.Ugrid2d(pts[:, 0], pts[:, 1], -1, tri.simplices.astype(np.int64))

    x, y = grid.face_coordinates.T
    elev = (
        40 * np.sin(x / 40e3) * np.cos(y / 60e3)
        + 10 * np.sin(x / 7e3)
        - 0.00005 * (x - cx)
    )
    da = xdata.DataArray(
        elev, dims=(grid.face_dimension,), name="elevation",
        attrs={"unit": "m", "long_name": "elevation (synthetic)"},
    )
    return xu.UgridDataArray(da, grid)


def adh_san_diego(n_times: int = 10, seed: int = 1):
    """
    The ADH_SanDiego sample: loads upstream xugrid's published
    ADH_SanDiego.nc when present in XUGRID_DATA_DIR
    (xugrid/data/sample_data.py:34-45), else a synthetic triangular
    coastal mesh with time-varying depth on the nodes.
    """
    import xugrid_tpu_torch as xu
    from scipy.spatial import Delaunay

    real = _load_real_ugrid("ADH_SanDiego.nc")
    if real is not None:
        return real

    rng = np.random.default_rng(seed)
    pts = rng.uniform([0.0, 0.0], [30e3, 40e3], (5000, 2))
    tri = Delaunay(pts)
    grid = xu.Ugrid2d(pts[:, 0], pts[:, 1], -1, tri.simplices.astype(np.int64))

    x, y = grid.node_coordinates.T
    elevation = -20 + 15 * np.tanh((x - 15e3) / 8e3)
    times = np.arange(n_times) * 3600.0
    phase = times[:, None] / 3600.0
    depth = (
        -elevation[None, :]
        + 0.8 * np.sin(2 * np.pi * phase / 12.42)
        + 0.1 * np.cos(x / 3e3)[None, :]
    )
    ds = xdata.Dataset()
    ds["elevation"] = ((grid.node_dimension,), elevation)
    ds["depth"] = (
        ("time", grid.node_dimension),
        depth,
        {"unit": "m"},
    )
    ds = ds.assign_coords(time=times)
    return xu.UgridDataset(ds, [grid])


def xoxo(seed: int = 2):
    """
    The xoxo sample: loads upstream xugrid's published vertex/triangle
    files when present in XUGRID_DATA_DIR (xugrid/data/sample_data.py:
    20-32), else a synthetic stand-in — two disjoint triangulated
    letter-like regions in one topology.
    """
    import xugrid_tpu_torch as xu
    from scipy.spatial import Delaunay

    from xugrid_tpu_torch.data.registry import fetch

    fv = fetch("xoxo_vertices.txt")
    ft = fetch("xoxo_triangles.txt")
    if fv is not None and ft is not None:
        vertices = np.loadtxt(fv, dtype=float)
        triangles = np.loadtxt(ft, dtype=int)
        return xu.Ugrid2d(vertices[:, 0], vertices[:, 1], -1, triangles)

    rng = np.random.default_rng(seed)

    def blob(cx, cy, n):
        pts = rng.normal([cx, cy], [8.0, 10.0], (n, 2))
        keep = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy) < 18.0
        return pts[keep]

    left = blob(20.0, 25.0, 1500)
    right = blob(70.0, 25.0, 1500)

    def triangulate(pts):
        tri = Delaunay(pts)
        return pts, tri.simplices.astype(np.int64)

    p1, t1 = triangulate(left)
    p2, t2 = triangulate(right)
    vertices = np.concatenate([p1, p2])
    triangles = np.concatenate([t1, t2 + len(p1)])
    grid = xu.Ugrid2d(vertices[:, 0], vertices[:, 1], -1, triangles)
    return grid


def provinces_nl():
    """
    Synthetic stand-in for provinces-nl.geojson: a GeoDataFrame of
    blobby polygon "provinces" (requires geopandas + shapely).
    """
    import geopandas as gpd
    import shapely

    rng = np.random.default_rng(3)
    polygons = []
    names = []
    for k in range(12):
        cx = rng.uniform(30e3, 220e3)
        cy = rng.uniform(30e3, 270e3)
        angle = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        radius = rng.uniform(15e3, 35e3) * (
            1.0 + 0.2 * np.sin(3 * angle + rng.uniform(0, np.pi))
        )
        ring = np.column_stack(
            [cx + radius * np.cos(angle), cy + radius * np.sin(angle)]
        )
        polygons.append(shapely.Polygon(ring))
        names.append(f"province_{k}")
    return gpd.GeoDataFrame({"name": names, "id": np.arange(12)}, geometry=polygons)


def hydamo_network(n_branches: int = 8, seed: int = 4):
    """
    Synthetic stand-in for the hydamo surface-water CSVs (upstream xugrid:
    xugrid/data/sample_data.py:69-89): returns (objects, points,
    profiles) GeoDataFrames — a branching channel network with gauge
    points and cross-section profile lines (requires geopandas +
    shapely).
    """
    import geopandas as gpd
    import shapely

    rng = np.random.default_rng(seed)
    lines = []
    names = []
    # A main channel with meandering branches sprouting off it.
    main = np.column_stack(
        [
            np.linspace(0.0, 50e3, 40),
            5e3 * np.sin(np.linspace(0, 3 * np.pi, 40)),
        ]
    )
    lines.append(shapely.LineString(main))
    names.append("main")
    for k in range(n_branches):
        t = rng.uniform(0.1, 0.9)
        i = int(t * (len(main) - 1))
        start = main[i]
        angle = rng.uniform(0.3, np.pi - 0.3) * rng.choice([-1, 1])
        length = rng.uniform(5e3, 15e3)
        s = np.linspace(0, 1, 15)
        wiggle = 800.0 * np.sin(s * rng.uniform(2, 5) * np.pi)
        dx = np.cos(angle) * length * s - np.sin(angle) * wiggle
        dy = np.sin(angle) * length * s + np.cos(angle) * wiggle
        lines.append(
            shapely.LineString(np.column_stack([start[0] + dx, start[1] + dy]))
        )
        names.append(f"branch_{k}")
    objects = gpd.GeoDataFrame(
        {"code": names, "id": np.arange(len(lines))}, geometry=lines
    )

    # Gauge points: sampled along the channels.
    pts = []
    codes = []
    for name, line in zip(names, lines):
        for frac in (0.25, 0.75):
            pts.append(line.interpolate(frac, normalized=True))
            codes.append(name)
    points = gpd.GeoDataFrame(
        {"code": codes, "value": rng.uniform(-2.0, 2.0, len(pts))},
        geometry=pts,
    )

    # Profiles: short lines perpendicular to the channel at midpoints.
    profs = []
    pcodes = []
    for name, line in zip(names, lines):
        mid = line.interpolate(0.5, normalized=True)
        ahead = line.interpolate(0.51, normalized=True)
        tx, ty = ahead.x - mid.x, ahead.y - mid.y
        norm = np.hypot(tx, ty) or 1.0
        nx, ny = -ty / norm, tx / norm
        half = 200.0
        profs.append(
            shapely.LineString(
                [
                    (mid.x - nx * half, mid.y - ny * half),
                    (mid.x + nx * half, mid.y + ny * half),
                ]
            )
        )
        pcodes.append(name)
    profiles = gpd.GeoDataFrame({"code": pcodes}, geometry=profs)
    return objects, points, profiles
