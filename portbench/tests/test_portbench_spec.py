"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
has its file."""

import json
import re

import pytest

from portbench import spec
from portbench.tests.small import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def benchmark():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys(benchmark):
    assert set(benchmark) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert benchmark["command"] == ["python3", "portbench/run.py"] and benchmark["paths"] == ["portbench"]
    assert 1 <= benchmark["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs_and_cells(benchmark):
    configs = {c["name"]: c for c in benchmark["configs"]}
    for c in benchmark["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert one_line(c["why"]) and one_line(c["source"]) and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    cells = benchmark["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and one_line(w["why"])
        traffic = json.loads((REPO / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "portbench" / "generators" / f"{traffic['generator']}.py").is_file()
    used = {w["config"] for w in cells}
    assert used == set(configs)


def test_metrics(benchmark):
    cells = {w["name"] for w in benchmark["workloads"]}
    names = [m["name"] for m in benchmark["end_to_end"] + benchmark["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in benchmark["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for m in benchmark["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in benchmark["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in benchmark["end_to_end"] + benchmark["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert spec.module_path(REPO, "metrics", m["name"]).is_file()
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in benchmark["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in benchmark["per_layer"])


def test_a_metric_without_a_file_reads_as_its_name_less_the_last_parts(tmp_path):
    folder = tmp_path / "portbench" / "metrics"
    folder.mkdir(parents=True)
    (folder / "rate.py").write_text("")
    (folder / "rate.host.py").write_text("")
    assert spec.module_path(tmp_path, "metrics", "rate.field") == folder / "rate.py"
    assert spec.module_path(tmp_path, "metrics", "rate.host") == folder / "rate.host.py"
    assert spec.module_path(tmp_path, "metrics", "rate.host.field.x") == folder / "rate.host.py"
    assert not spec.module_path(tmp_path, "metrics", "other.rate").is_file()
