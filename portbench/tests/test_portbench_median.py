"""The cell ``lhm250.median_year`` at a size a CPU test run holds: the
port's run is correct and its bfloat16 control is not; planted faults
read not correct; its configuration, traffic, generator and metric
files are found by name; its readers read what the port records and
nothing where the port records nothing."""

import pytest
import torch

from portbench import control, rooflines, spec
from portbench.harness import Call, Context
from portbench.tests.small import REPO, run_cpu, small_root
from portbench.tests.test_portbench_isolation import top_level_modules
from portbench.tracing import TraceSummary

CELL = "lhm250.median_year"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("median"))


def test_port_run_is_correct_and_counts_its_windows(root):
    result, lines = run_cpu(root, CELL, seed=2147483701)
    assert result["correct"] and result["failed"] == 0, lines
    assert set(result["metrics"]) == {"regrid_slices_per_s", "setup_s"}
    assert result["checks"]["median_rel_err"]["value"] < 1e-7, lines
    # 10 x 11 map cells of 16 faces each, 8 slices a call, in one slab.
    assert "port counters, mean per call: select.span_us " in "\n".join(lines)
    assert any(line.endswith("select.spans 1, select.walk_launches 0, select.windows 880") for line in lines), lines
    assert "window_select: padded window width w 16" in lines


def test_traced_run_reads_the_dispatch_span_and_no_card_kernel(root):
    result, lines = run_cpu(root, CELL, seed=2147483659, trace=True)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"select.dispatch_us"}
    assert result["metrics"]["select.dispatch_us"]["value"] > 0


@pytest.mark.parametrize("seed", [3, 2147483701])
def test_control_fails(root, seed):
    readings = control.readings(root, CELL, seed, torch.device("cpu"))
    assert readings["precision"] == "bfloat16" and not readings["passes"], readings
    assert readings["checks"]["median_rel_err"]["value"] > 1e-3, readings


def mean_for_median(monkeypatch):
    from xugrid_tpu_torch.regrid import reduce

    monkeypatch.setitem(reduce.ABSOLUTE_OVERLAP_METHODS, "median", reduce.mean)


def p49_for_p50(monkeypatch):
    from xugrid_tpu_torch.regrid import reduce

    monkeypatch.setitem(reduce.ABSOLUTE_OVERLAP_METHODS, "median", reduce.Percentile(49))


def nan_taken_as_value(monkeypatch):
    """The first NaN of each slab's source ranked as 0.0: one window takes
    a value that is not there."""
    from xugrid_tpu_torch.regrid import regridder

    original = regridder.apply_weights

    def apply_weights(weights, source, *args, **kwargs):
        source = source.clone()
        source.view(-1)[torch.isnan(source).view(-1).nonzero()[0]] = 0.0
        return original(weights, source, *args, **kwargs)

    monkeypatch.setattr(regridder, "apply_weights", apply_weights)


def nan_in_output(monkeypatch):
    """One value of each result made NaN where it is produced."""
    from xugrid_tpu_torch.regrid import regridder

    original = regridder.apply_weights

    def apply_weights(*args, **kwargs):
        out = original(*args, **kwargs)
        out.reshape(-1)[out.numel() // 2] = float("nan")
        return out

    monkeypatch.setattr(regridder, "apply_weights", apply_weights)


@pytest.mark.parametrize("fault", [mean_for_median, p49_for_p50, nan_taken_as_value, nan_in_output],
                         ids=lambda f: f.__name__)
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
    assert config["name"] == "lhm250_median1km" and config["method"] == traffic["method"] == "median"
    assert (REPO / "portbench" / "generators" / f"{traffic['generator']}.py").is_file()
    for name in ("window_select_roofline", "select.dispatch_us"):
        assert spec.module_path(REPO, "metrics", name).name == f"{name}.py"
    assert "lhm250.median_year" in [m for e in benchmark["end_to_end"] if e["name"] == "regrid_slices_per_s"
                                    for m in e["workloads"]]


def roofline(launches_per_call):
    """Four traced calls of E = 300 slices, each in ``launches_per_call``
    launches taking 3 us over them."""
    trace = TraceSummary(calls=4, window_s=1.0, busy_s=0.5)
    trace.kernels["void xt::window_select_kernel<float, false, 16, true>"] = [4 * launches_per_call, 4 * 3e-6]
    trace.kernels["void xt::window_reduce_kernel<float, 0, true, 4>"] = [4, 1.0]
    counts = {"window_select": {"nnz": 1000, "m": 10_000, "n": 500, "E": 300}}
    return spec.load_module(REPO, "metrics", "window_select_roofline").read(Context([], 1.0, 0.0, trace, counts))


def test_roofline_gives_each_launch_its_mean_slab():
    assert roofline(1) == pytest.approx(rooflines.share_pct(rooflines.window_reduce_bytes(1000, 10_000, 500, 300), 3e-6))
    assert roofline(3) == pytest.approx(rooflines.share_pct(rooflines.window_reduce_bytes(1000, 10_000, 500, 100), 1e-6))
    assert spec.load_module(REPO, "metrics", "window_select_roofline").read(Context([], 1.0, 0.0)) is None


def test_dispatch_reader_reads_untraced_calls_only():
    def call(traced, spans, span_us):
        return Call(0.0, 1.0, 1.0, 1, traced, False, {"select": {"spans": spans, "span_us": span_us}})

    read = spec.load_module(REPO, "metrics", "select.dispatch_us").read
    assert read(Context([call(False, 9, 90.0), call(False, 9, 180.0), call(True, 9, 900.0)], 1.0, 0.0)) == 15.0
    assert read(Context([call(False, 0, 0.0)], 1.0, 0.0)) is None
    assert read(Context([Call(0.0, 1.0, 1.0, 1, False, False, None)], 1.0, 0.0)) is None


def no_recorder(monkeypatch):
    """A port without span recording (before its spans were added)."""
    from xugrid_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling.TimingRegistry, "start_spans")


def no_select_span(monkeypatch):
    """A port that records spans but has no ``apply.select``."""
    from xugrid_tpu_torch.regrid import select_apply
    from xugrid_tpu_torch.utils.profiling import _NO_SPAN

    monkeypatch.setattr(select_apply, "span", lambda name: _NO_SPAN)
    monkeypatch.setattr(select_apply, "count", lambda name, n: None)


@pytest.mark.parametrize("older", [no_recorder, no_select_span], ids=lambda f: f.__name__)
def test_a_port_without_the_span_runs_correct_and_leaves_the_metric_out(root, monkeypatch, older):
    older(monkeypatch)
    result, lines = run_cpu(root, CELL, seed=2147483659, trace=True)
    assert result["correct"], lines
    assert "select.dispatch_us" not in result["metrics"]


def test_generator_loads_no_jax():
    from portbench.harness import FORBIDDEN_MODULES

    assert not top_level_modules(["portbench.generators.regrid_select"]) & FORBIDDEN_MODULES
