"""On the card, at a small size: each cell runs correct, and its traced
run reads the port's kernels and a busy device from the profile.  Run
there with ``python -m pytest -p no:cacheprovider portbench/tests``."""

import json
import time

import pytest
import torch

from portbench import harness
from portbench.tests.small import HELD_CELLS, REPO, small_root

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"] + HELD_CELLS]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(tmp_path, workload):
    device = harness.look_for_chips(1)
    if device is None:
        pytest.skip("needs a CUDA card")
    root = small_root(tmp_path, nx=400, ny=440)
    result, lines = harness.run(root, workload, 2147483647, 1.0, True, device, time.perf_counter())
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert any("window_reduce_kernel" in name for name, _ in result["breakdown"]["device_ops"])
    assert torch.cuda.max_memory_allocated(device) > 0
