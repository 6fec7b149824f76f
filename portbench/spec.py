"""The benchmark's specification (``BENCHMARK.json``) and the files it
names, found by name under the benchmark's folder."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path

#: The benchmark's folder, relative to the checkout's root.
FOLDER = "portbench"


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for workload in spec["workloads"]:
        if workload["name"] == name:
            return workload
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(root: Path, spec: dict, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            return json.loads((Path(root) / entry["file"]).read_text())
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> dict:
    return json.loads((Path(root) / FOLDER / "traffic" / f"{name}.json").read_text())


def _applies(metric: dict, workload: dict, reported_e2e: set) -> bool:
    if "workloads" in metric:
        return workload["name"] in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported_e2e


def metrics(spec: dict, workload: dict, traced: bool) -> list:
    """The cell's end-to-end metrics (``traced`` False) or per-layer
    metrics (``traced`` True), as BENCHMARK.json lists them."""
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload, set())]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if _applies(m, workload, names)]


def module_path(root: Path, kind: str, name: str) -> Path:
    """``<folder>/<kind>/<name>.py``; for a metric without a file of its
    own, the file of the name less its last dotted parts: the reader of
    ``regrid_slices_per_s.field`` is ``regrid_slices_per_s.py``, the same quantity
    under a second name (a bound belongs to a name), read alike."""
    folder = Path(root) / FOLDER / kind
    stem = name
    while not (folder / f"{stem}.py").is_file() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
    return folder / f"{stem}.py"


def load_module(root: Path, kind: str, name: str):
    """The module of ``module_path`` (a name may hold dots, so it is
    loaded by path, not imported)."""
    path = module_path(root, kind, name)
    tag = hashlib.blake2b(str(path).encode(), digest_size=6).hexdigest()
    module_spec = importlib.util.spec_from_file_location(f"{FOLDER}_{kind}_{tag}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module
