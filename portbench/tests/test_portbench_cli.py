"""The command refuses to run without the cell's card: it exits non-zero
and prints no result."""

import os
import subprocess
import sys

from portbench.tests.small import REPO


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lhm250.heads_year", "--seed", "2147483653",
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    # A directory with only BENCHMARK.json and the benchmark's folder:
    # the port is missing, so no cell can run.
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lhm250.heads_year", "--seed", "7", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
