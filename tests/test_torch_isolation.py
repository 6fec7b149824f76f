"""
The port stands alone: in a fresh interpreter, ``import xugrid_tpu_torch``
and a CPU regrid load neither jax nor xugrid_tpu, and launch no kernel.
A subprocess is needed because the test session itself imports jax.

``chip_smoke.py`` refuses to run without a CUDA device: exit code 2 and
no result printed.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGRID_ON_CPU = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch

    import xugrid_tpu_torch as xt
    from xugrid_tpu_torch.regrid.aligned_apply import window_reduce
    from xugrid_tpu_torch.regrid.select_apply import window_select

    def quad(n, dx):
        x = np.arange(n + 1.0) * dx
        yy, xx = np.meshgrid(x, x, indexing="ij")
        j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        nid = lambda ii, jj: jj * (n + 1) + ii
        faces = np.stack([nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], -1)
        return xt.Ugrid2d(xx.ravel(), yy.ravel(), -1, faces.reshape(-1, 4))

    source, target = quad(12, 1.0), quad(5, 12 / 5)
    data = torch.from_numpy(np.random.default_rng(0).normal(size=(2, source.n_face)))
    for cls, method in [(xt.OverlapRegridder, "mean"), (xt.OverlapRegridder, "median"),
                        (xt.RelativeOverlapRegridder, "first_order_conservative")]:
        out = cls(source, target, method=method).regrid(data)
        assert out.shape == (2, target.n_face) and bool(torch.isfinite(out).all()), method
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "xugrid_tpu" or m.startswith("xugrid_tpu."))
    assert not loaded, loaded
    assert window_reduce.launches == 0 and window_select.launches == 0
    print("isolated")
    """
)


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_imports_neither_jax_nor_xugrid_tpu():
    proc = _run(["-c", REGRID_ON_CPU], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "isolated"


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""
