"""
Where an entry point runs: on the CUDA card unless the caller asks for
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(data=None, device=None) -> torch.device:
    """
    The device an entry point computes on.

    ``device=None`` means the device of ``data`` when it is a tensor, and
    ``cuda`` for anything else (a numpy array, a list).  Raises
    RuntimeError when that is a CUDA device and no card is present: the
    CPU is taken only when asked for, with ``device="cpu"``.  A CUDA
    device comes back with its index (``cuda`` is the current card), so
    that caches keyed by device see one card under one key.
    """
    if device is None:
        device = data.device if isinstance(data, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
