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
    CPU is taken only when asked for, with ``device="cpu"``.
    """
    if device is None:
        device = data.device if isinstance(data, torch.Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
