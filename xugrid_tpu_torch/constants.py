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

# Host dtypes (numpy).
IntDType = np.int64
FloatDType = np.float64
