"""
Times, on one CUDA card, the torch scans and sorts under the payload
methods of ``xugrid_tpu_torch.xdata`` (rank, ffill, interpolate_na) on a
(20, 1,000,000) payload, the shape of ``chip_smoke.py`` phase 13: cummax,
cummin and a stable sort along the last axis of a (1M, 20) copy against
the first axis of the (20, 1M) original, in float32 and float64, then
the port's ``rank_tensor``, ``fill_directional_tensor`` and
``interpolate_tensor`` themselves.  CUDA events, median of 7 runs of 5
calls after a warm-up.

    python3 scripts/scan_axis_probe.py
"""

import statistics
import subprocess
import sys

import numpy as np
import torch


def ms(fn, reps=7, inner=5):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_axis_probe: no CUDA device", file=sys.stderr)
        return 2
    from xugrid_tpu_torch.xdata import variable

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rng = np.random.default_rng(13)
    values = (np.round(rng.normal(size=(20, 1_000_000)) * 2.0) / 2.0).astype(np.float32)
    values[rng.random(values.shape) < 0.01] = np.nan
    x = np.cumsum(rng.uniform(0.5, 1.5, 20))
    for dtype in (torch.float32, torch.float64):
        first = torch.from_numpy(values).to("cuda", dtype)
        last = first.t().contiguous()
        print(
            f"{dtype}: cummax along the last axis {ms(lambda: last.cummax(dim=-1)):.3f} ms, the first "
            f"{ms(lambda: first.cummax(dim=0)):.3f} ms; stable sort along the last axis "
            f"{ms(lambda: torch.sort(last, dim=-1, stable=True)):.3f} ms, the first "
            f"{ms(lambda: torch.sort(first, dim=0, stable=True)):.3f} ms [{card}]"
        )
    payload = torch.from_numpy(values).cuda()
    print(
        f"rank_tensor {ms(lambda: variable.rank_tensor(payload, 0)):.3f} ms, fill_directional_tensor "
        f"{ms(lambda: variable.fill_directional_tensor(payload, 0, 2, False)):.3f} ms, interpolate_tensor linear "
        f"{ms(lambda: variable.interpolate_tensor(payload, x, 0, 'linear', False)):.3f} ms, extrapolate "
        f"{ms(lambda: variable.interpolate_tensor(payload, x, 0, 'linear', True)):.3f} ms [{card}]"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
