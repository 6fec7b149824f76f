"""
Shared constants and dtypes.

Two tiers, as in ``xugrid_tpu.constants``: topology and weight builds
run on the host in numpy (float64/int64); the regrid apply runs on
torch tensors in the caller's dtype, with int32 window indices.
"""

from __future__ import annotations

import numpy as np

# Fill value marking missing entries in padded dense connectivity arrays.
# Other fills and 1-based indices are normalized to this at ingest.
FILL_VALUE: int = -1

# Tolerance of near-degenerate geometry tests: the float64 machine
# epsilon, scaled by coordinate extents where it is used.
X_EPSILON: float = float(np.finfo(np.float64).eps)
X_OFFSET = 1e-9

# Host dtypes (numpy).
IntDType = np.int64
FloatDType = np.float64

# Device dtypes: int32 window indices, float32 payloads unless the
# caller's data is float64.
DeviceIntDType = np.int32
DeviceFloatDType = np.float32

IntArray = np.ndarray
FloatArray = np.ndarray
BoolArray = np.ndarray


class Point(np.ndarray):
    """Tiny convenience view: (x, y) as an ndarray subclass."""

    def __new__(cls, x: float, y: float):
        return np.asarray([x, y], dtype=np.float64).view(cls)

    @property
    def x(self) -> float:
        return float(self[0])

    @property
    def y(self) -> float:
        return float(self[1])


class Vector(Point):
    pass


class MissingOptionalModule:
    """Stands in for an optional dependency that is not installed: any
    use raises an ImportError naming it."""

    def __init__(self, name: str):
        self.name = name

    def __getattr__(self, attr):
        raise ImportError(f"{self.name} is required for this functionality")

    def __call__(self, *args, **kwargs):
        raise ImportError(f"{self.name} is required for this functionality")


def optional_import(name: str):
    """Import ``name`` if available, else return a MissingOptionalModule;
    with a flag saying which."""
    import importlib

    try:
        return importlib.import_module(name), True
    except ImportError:
        return MissingOptionalModule(name), False
