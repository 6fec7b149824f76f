"""
Times, on one CUDA card, the least-squares solvers for the port's
``polyfit`` on the shape of ``chip_smoke.py`` phase 15.6: a (48, 2)
Vandermonde matrix of hourly steps against 1,048,576 float64 columns (a
linear fit per cell of a 1024 x 1024 raster).  ``torch.linalg.lstsq``
(LAPACK's ``gels``, its only solver on CUDA), ``torch.linalg.qr`` with
``solve_triangular``, and ``xugrid_tpu_torch.xdata.variable.lstsq_tall``
(the port's solver: the small QR on the host, one matrix product and
back substitution on the card).  Each is timed with CUDA events, one
cold call then one warm call, and its solution held to numpy's
``lstsq`` on 100 columns at rtol 1e-9.

    python3 scripts/lstsq_probe.py
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def once_ms(fn):
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstsq_probe: no CUDA device", file=sys.stderr)
        return 2
    from xugrid_tpu_torch.xdata import variable

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    rng = np.random.default_rng(15)
    hours = np.arange(48.0)
    vander = np.vander(hours, 2)
    values = rng.normal(size=(48, 1 << 20)) + 0.05 * hours[:, None]
    Y = torch.from_numpy(values).cuda()
    V = torch.from_numpy(vander).cuda()
    columns = rng.choice(values.shape[1], size=100, replace=False)
    want = np.linalg.lstsq(vander, values[:, columns], rcond=None)[0]

    def qr_solve():
        Q, R = torch.linalg.qr(V)
        return torch.linalg.solve_triangular(R, Q.T @ Y, upper=True)

    solvers = (
        ("torch.linalg.lstsq", lambda: torch.linalg.lstsq(V, Y).solution),
        ("torch.linalg.qr + solve_triangular", qr_solve),
        ("variable.lstsq_tall", lambda: variable.lstsq_tall(vander, Y)),
    )
    for name, solve in solvers:
        _, cold = once_ms(solve)
        got, warm = once_ms(solve)
        np.testing.assert_allclose(got[:, columns].cpu().numpy(), want, rtol=1e-9, atol=1e-12)
        print(f"{name}: (48, 2) against (48, {values.shape[1]}) float64, cold {cold:.3f} ms, warm {warm:.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
