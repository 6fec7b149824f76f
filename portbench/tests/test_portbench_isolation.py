"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the port: checked in a fresh interpreter by
whole top-level module names."""

import json
import subprocess
import sys

from portbench.tests.small import REPO

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import importlib
for name in {modules!r}:
    importlib.import_module(name)
from pathlib import Path
from portbench import spec
for path in sorted((Path({root!r}) / "portbench" / "metrics").glob("*.py")):
    spec.load_module(Path({root!r}), "metrics", path.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(modules):
    code = PROBE.format(root=str(REPO), modules=modules)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_generators_readers_and_reference_load_no_jax():
    from portbench.harness import FORBIDDEN_MODULES

    modules = [
        "portbench.harness", "portbench.tracing", "portbench.readers", "portbench.control",
        "portbench.generators.regrid_loop", "portbench.generators.new_target", "portbench.reference.overlap",
    ]
    loaded = top_level_modules(modules)
    assert not loaded & FORBIDDEN_MODULES


def test_the_port_loads_no_jax():
    from portbench.harness import FORBIDDEN_MODULES

    loaded = top_level_modules(["xugrid_tpu_torch", "xugrid_tpu_torch.regrid.regridder"])
    assert "xugrid_tpu_torch" in loaded and not loaded & FORBIDDEN_MODULES


def test_reference_loads_nothing_of_the_port():
    loaded = top_level_modules(["portbench.reference.overlap", "portbench.inputs"])
    assert "xugrid_tpu_torch" not in loaded and "xugrid_tpu" not in loaded


def test_names_are_compared_whole():
    from portbench import harness

    before = dict(sys.modules)
    try:
        sys.modules["xugrid_tpu_torch_probe"] = object()
        sys.modules["jaxish"] = object()
        assert harness.forbidden_modules() == [m for m in harness.forbidden_modules() if m.split(".")[0] in harness.FORBIDDEN_MODULES]
        assert "xugrid_tpu_torch_probe" not in harness.forbidden_modules()
        sys.modules["xugrid_tpu.probe"] = object()
        assert "xugrid_tpu.probe" in harness.forbidden_modules()
    finally:
        for name in set(sys.modules) - set(before):
            del sys.modules[name]
