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

# Host dtypes (numpy).
IntDType = np.int64
FloatDType = np.float64


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
