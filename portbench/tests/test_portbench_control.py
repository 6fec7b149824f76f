"""Each cell's control (the reference in the port's place, one precision
below the configuration's) comes out not correct, while the port's own
run comes out correct, at a size a test run holds.  On the card the same
control runs at the cells' sizes with ``portbench/control.py``."""

import pytest
import torch

from portbench import control
from portbench.tests.small import run_cpu, small_root

CELLS = ["lhm250.heads_year", "lhm250.new_map", "lhm250.one_field"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [3, 2147483701])
def test_control_fails(root, workload, seed):
    readings = control.readings(root, workload, seed, torch.device("cpu"))
    assert not readings["passes"], readings


@pytest.mark.parametrize("workload", CELLS)
def test_port_passes(root, workload):
    result, lines = run_cpu(root, workload, seed=2147483701)
    assert result["correct"], lines
