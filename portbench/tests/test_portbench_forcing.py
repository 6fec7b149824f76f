"""The cell ``raster1km_lhm250.forcing`` at a size a CPU test run holds:
the port's run is correct and its bfloat16 control is not; planted
faults read not correct; its configuration, traffic, generator and
metric files are found by name; its readers read what the port records
and nothing where the port records nothing."""

import pytest
import torch

from portbench import control, rooflines, spec
from portbench.harness import Call, Context
from portbench.tests.small import REPO, run_cpu, small_root
from portbench.tests.test_portbench_isolation import top_level_modules
from portbench.tracing import TraceSummary

CELL = "raster1km_lhm250.forcing"
#: small.py's mesh: 40 x 44 faces of 250 m, each in one of 10 x 11 map cells.
FACES = 40 * 44


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("forcing"))


@pytest.mark.parametrize("seed", [3, 2147483701])
def test_port_run_is_correct_and_counts_its_wrap(root, seed):
    result, lines = run_cpu(root, CELL, seed=seed)
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["metrics"]) == {"regrid_slices_per_s", "setup_s"}
    # One rounding of the product and one of the quotient, v w / w.
    assert result["checks"]["mean_rel_err"]["value"] < 3e-7, lines
    assert "window_reduce: padded window width w 1" in lines
    counted = next(line for line in lines if line.startswith("port counters, mean per call: "))
    assert f"wrap.coord_bytes {8 * FACES}, wrap.span_us " in counted and counted.endswith(", wrap.spans 1"), lines


def test_traced_run_reads_the_wrap_span_and_no_card_kernel(root):
    result, lines = run_cpu(root, CELL, seed=2147483659, trace=True)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"regrid.wrap_us"}
    assert result["metrics"]["regrid.wrap_us"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 2147483701])
def test_control_fails(root, seed):
    readings = control.readings(root, CELL, seed, torch.device("cpu"))
    assert readings["precision"] == "bfloat16" and not readings["passes"], readings
    assert readings["checks"]["mean_rel_err"]["value"] > 1e-3, readings


def rows_flipped_in_y(monkeypatch):
    """The raster's cells numbered south first while its payload is held
    north first: each face takes the value of the cell mirrored in y."""
    from xugrid_tpu_torch.regrid import structured

    monkeypatch.setattr(structured.StructuredGrid1d, "directional_bounds", property(lambda self: self.bounds))


def mean_over_map_cells(monkeypatch):
    """The weights normalised over each map cell, the grouping of the
    other direction, in place of over each face: each cell's value shared
    out over its faces by area (the relative overlap's sum of w v)."""
    from xugrid_tpu_torch.regrid import reduce, regridder

    def compute(self, source, target, tolerance=None):
        return self._overlap_weights(source, target, relative=True)

    monkeypatch.setattr(regridder.OverlapRegridder, "_compute_weights", compute)
    monkeypatch.setitem(reduce.ABSOLUTE_OVERLAP_METHODS, "mean", reduce.first_order_conservative)


def nan_dropped(monkeypatch):
    """The first NaN of each result given a value where it is produced."""
    from xugrid_tpu_torch.regrid import regridder

    original = regridder.apply_weights

    def apply_weights(*args, **kwargs):
        out = original(*args, **kwargs)
        flat = out.view(-1)
        missing = torch.isnan(flat).nonzero()
        if len(missing):
            flat[missing[0]] = 10.0
        return out

    monkeypatch.setattr(regridder, "apply_weights", apply_weights)


@pytest.mark.parametrize("fault", [rows_flipped_in_y, mean_over_map_cells, nan_dropped], ids=lambda f: f.__name__)
def test_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    result, lines = run_cpu(root, CELL, seed=2147483659)
    assert not result["correct"], lines
    assert result["failed"] == 0, lines


def test_new_files_are_found():
    benchmark = spec.load(REPO)
    cell = spec.cell(benchmark, CELL)
    config = spec.config(REPO, benchmark, cell["config"])
    traffic = spec.traffic(REPO, cell["traffic"])
    assert config["name"] == "raster1km_lhm250_forcing" and config["method"] == traffic["method"] == "mean"
    assert config["payload"] == {"variables": 2, "time": 1827, "dtype": "float32", "nan_share": 0.01}
    assert (REPO / "portbench" / "generators" / f"{traffic['generator']}.py").is_file()
    assert (REPO / "portbench" / "reference" / "forcing.py").is_file()
    assert spec.module_path(REPO, "metrics", "regrid.wrap_us").name == "regrid.wrap_us.py"
    assert spec.module_path(REPO, "metrics", "window_reduce_roofline.mesh_target").name == "window_reduce_roofline.py"
    e2e = {m["name"]: m for m in benchmark["end_to_end"]}
    assert CELL in e2e["regrid_slices_per_s"]["workloads"]
    names = [m["name"] for m in spec.metrics(benchmark, cell, traced=True)]
    assert names == ["window_reduce_roofline.mesh_target", "regrid.wrap_us"]


def test_roofline_reads_the_cells_frozen_bytes():
    """Four traced calls of E = 1,827 slices in 7 launches, 3 us each."""
    trace = TraceSummary(calls=4, window_s=1.0, busy_s=0.5)
    trace.kernels["void xt::window_reduce_kernel<float, 0, true, 4>"] = [4 * 7, 4 * 7 * 3e-6]
    counts = {"window_reduce": {"nnz": 1000, "m": 500, "n": 8000, "E": 1827}}
    read = spec.load_module(REPO, "metrics", "window_reduce_roofline.mesh_target").read
    expected = rooflines.share_pct(rooflines.window_reduce_bytes(1000, 500, 8000, 1827 / 7), 3e-6)
    assert read(Context([], 1.0, 0.0, trace, counts)) == pytest.approx(expected)
    assert read(Context([], 1.0, 0.0)) is None


def test_wrap_reader_reads_untraced_calls_only():
    def call(traced, spans, span_us):
        return Call(0.0, 1.0, 1.0, 1, traced, False, {"wrap": {"spans": spans, "span_us": span_us, "coord_bytes": 8}})

    read = spec.load_module(REPO, "metrics", "regrid.wrap_us").read
    assert read(Context([call(False, 1, 900.0), call(False, 1, 1100.0), call(True, 1, 9000.0)], 1.0, 0.0)) == 1000.0
    assert read(Context([call(False, 0, 0.0)], 1.0, 0.0)) is None
    assert read(Context([Call(0.0, 1.0, 1.0, 1, False, False, None)], 1.0, 0.0)) is None


def no_recorder(monkeypatch):
    """A port without span recording (before its spans were added)."""
    from xugrid_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling.TimingRegistry, "start_spans")


def no_wrap_span(monkeypatch):
    """A port that records spans but has no ``regrid.wrap``, nor the
    counter ``wrap.coord_bytes``."""
    from xugrid_tpu_torch.core import wrap
    from xugrid_tpu_torch.regrid import regridder
    from xugrid_tpu_torch.utils.profiling import _NO_SPAN, span

    monkeypatch.setattr(regridder, "span", lambda name: _NO_SPAN if name == "regrid.wrap" else span(name))
    monkeypatch.setattr(wrap, "count", lambda name, n: None)


@pytest.mark.parametrize("older", [no_recorder, no_wrap_span], ids=lambda f: f.__name__)
def test_a_port_without_the_span_runs_correct_and_leaves_the_metric_out(root, monkeypatch, older):
    older(monkeypatch)
    result, lines = run_cpu(root, CELL, seed=2147483659, trace=True)
    assert result["correct"], lines
    assert "regrid.wrap_us" not in result["metrics"]


def test_generator_and_reference_load_no_jax_and_the_reference_nothing_of_the_port():
    from portbench.harness import FORBIDDEN_MODULES

    assert not top_level_modules(["portbench.generators.regrid_forcing"]) & FORBIDDEN_MODULES
    loaded = top_level_modules(["portbench.reference.forcing"])
    assert not loaded & (FORBIDDEN_MODULES | {"xugrid_tpu_torch"})
