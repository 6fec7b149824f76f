"""
Sample-data registry: the filenames of upstream xugrid's published sample
datasets, resolved against local directories (``XUGRID_DATA_DIR``, then
the user's cache directory).  Nothing is downloaded: the loaders take
their synthetic stand-ins when a file is absent.  Copied from
``xugrid_tpu/data/registry.py`` without its download branch.
"""

from __future__ import annotations

import os

#: filenames of upstream xugrid's published sample datasets.
FILES = (
    "xoxo_vertices.txt",
    "xoxo_triangles.txt",
    "ADH_SanDiego.nc",
    "elevation_nl.nc",
    "provinces-nl.geojson",
    "hydamo_objects.csv",
    "hydamo_points.csv",
    "hydamo_profiles.csv",
)


def data_dirs():
    """Candidate directories, highest priority first."""
    dirs = []
    env = os.environ.get("XUGRID_DATA_DIR")
    if env:
        dirs.append(env)
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    dirs.append(os.path.join(cache, "xugrid"))
    return dirs


def fetch(filename: str):
    """Path to a local copy of a registered sample file, or None."""
    if filename not in FILES:
        raise ValueError(f"Unknown sample file: {filename}")
    for d in data_dirs():
        path = os.path.join(d, filename)
        if os.path.exists(path):
            return path
    return None
