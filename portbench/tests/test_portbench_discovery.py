"""A later change adds a configuration, a traffic mix and a metric as
files of their own, and an entry each in BENCHMARK.json: the harness
finds them by name, with no file it already has edited."""

import json

from portbench.tests.small import run_cpu, small_root


def test_new_config_traffic_and_metric_files_are_found(tmp_path):
    root = small_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    folder = root / "portbench"
    config = json.loads((folder / "configs" / "lhm250_raster1km.json").read_text())
    config["name"] = "mesh2k_raster8"
    config["mesh"].update(nx=30, ny=30, jitter=0.15)
    config["raster"]["cell"] = 30 * 250.0 / 8
    config["payload"].update(variables=3, time=1, layer=3)
    (folder / "configs" / "mesh2k_raster8.json").write_text(json.dumps(config))
    traffic = json.loads((folder / "traffic" / "regrid_whole_variable.json").read_text())
    (folder / "traffic" / "regrid_mean_three.json").write_text(json.dumps(traffic))
    (folder / "metrics" / "regrid.calls_seen.py").write_text(
        '"""regrid.calls_seen: how many calls the window made."""\n\n\ndef read(ctx):\n    return len(ctx.calls)\n'
    )
    benchmark = json.loads((root / "BENCHMARK.json").read_text())
    benchmark["configs"].append(
        {"name": "mesh2k_raster8", "source": "https://example.org/x", "file": "portbench/configs/mesh2k_raster8.json",
         "reduced": [], "why": "a test"}
    )
    benchmark["workloads"].append(
        {"name": "small.three", "config": "mesh2k_raster8", "traffic": "regrid_mean_three", "chips": 1, "why": "a test"}
    )
    for metric in benchmark["end_to_end"]:
        if metric["name"] == "regrid_slices_per_s":
            metric["workloads"].append("small.three")
    benchmark["per_layer"].append(
        {"name": "regrid.calls_seen", "unit": "calls", "better": "higher", "source": "host_clock",
         "layer": "labelled wrapper and apply dispatch", "moves": "regrid_slices_per_s", "workloads": ["small.three"]}
    )
    (root / "BENCHMARK.json").write_text(json.dumps(benchmark))

    result, _ = run_cpu(root, "small.three", trace=True)
    assert result["correct"]
    assert result["metrics"]["regrid.calls_seen"]["value"] == result["attempted"]
    result, _ = run_cpu(root, "small.three")
    assert set(result["metrics"]) == {"regrid_slices_per_s", "setup_s"}
    for path, content in before.items():
        assert path.read_bytes() == content, path
