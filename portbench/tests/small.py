"""A copy of the benchmark at a size a CPU test run holds: the same
files, with the configurations' meshes, rasters and pools cut down and
the traffic's stacks and warm-ups shortened."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import harness

REPO = Path(__file__).resolve().parents[2]

#: Cells proven on the card and held out of BENCHMARK.json while their
#: host-bound runs spread too widely for a bound (PERF.md, open
#: questions); the copies here hold them too, so that their traffic and
#: generators stay tested.
HELD_CELLS = [
    {"name": "lhm250.new_map", "config": "lhm250_raster1km", "traffic": "regrid_new_map", "chips": 1, "why": "held"},
    {"name": "lhm250.one_field", "config": "lhm250_raster1km", "traffic": "regrid_one_field", "chips": 1, "why": "held"},
]


def small_root(tmp_path: Path, nx: int = 40, ny: int = 44, time: int = 4, layer: int = 2) -> Path:
    """Meshes of nx x ny faces (rasters as many cells fewer as their
    cells are larger), variables of (time, layer) slices."""
    root = Path(tmp_path) / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    benchmark = json.loads((REPO / "BENCHMARK.json").read_text())
    benchmark["workloads"] += HELD_CELLS
    (root / "BENCHMARK.json").write_text(json.dumps(benchmark))
    for path in (root / "portbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["mesh"].update(nx=nx, ny=ny)
        config["payload"].update(time=time, layer=layer)
        path.write_text(json.dumps(config))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic["warmup_calls"] = min(traffic["warmup_calls"], 2)
        traffic["trace"] = dict(traffic["trace"], after_s=0.0, calls=2)
        path.write_text(json.dumps(traffic))
    return root


def run_cpu(root: Path, workload: str, seed: int = 12345, seconds: float = 0.3, trace: bool = False) -> tuple:
    """One run of ``workload`` on the CPU, the look for a card skipped."""
    import time

    return harness.run(root, workload, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
