"""Every cell, configuration, driver and metric of BENCHMARK.json resolves
from its files by name, and a cell and a metric added as files alone are
picked up."""

from __future__ import annotations

import json
import shutil

import pytest
from conftest import ROOT

from portbench.bench import benchmark, resolve, spans_of

BENCH = benchmark(ROOT)


def test_names_and_units_are_well_formed():
    names = [m["name"] for kind in ("end_to_end", "per_layer") for m in BENCH[kind]]
    names += [c["name"] for c in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names:
        assert len(name) <= 64 and (name[0].isalnum() or name[0] == "_")
        assert all(ch.isalnum() and ch.isascii() or ch in "_.-" for ch in name)
    for m in BENCH["per_layer"]:
        e2e = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in e2e or w in e2e["workloads"]
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert {"setup_s", "maps_per_min", "train_samples_per_s", "train_step_ms_p95"} <= {
        e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_resolves(cell_name):
    cell = resolve(BENCH, cell_name)
    assert cell.wl["config"] == cell.entry["config"] == cell.cfg["name"]
    assert callable(cell.driver.build)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for _, module in list(cell.end_to_end.values()) + list(cell.per_layer.values()):
        assert callable(module.read)
    spans, ranges = spans_of(cell)
    assert all(":" in spec for spec in spans.values())
    assert {f"portbench.{s}" for s in spans} <= ranges


def test_every_config_file_is_listed():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert c["source"] in cfg["source"]


@pytest.mark.parametrize("name", ["predict.mapset-120s", "train.denoiser-l152"])
def test_a_cell_and_a_metric_added_as_files(tmp_path, name):
    """a copy of the benchmark's folder plus one workload file and one metric
    file, and the entries naming them: the new cell and metric resolve"""
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    wl = json.loads((here / "workloads" / f"{name}.json").read_text())
    (here / "workloads" / "added.mix.json").write_text(json.dumps(wl))
    (here / "metrics" / "added_ms.layer.py").write_text(
        "SPANS = {'added': 'osu_dreamer_tpu_torch.nn.norm:rms_norm'}\n"
        "def read(run):\n    return 1.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "added.cell", "config": wl["config"],
                               "traffic": "added.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "added_ms.layer", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "setup_s", "workloads": ["added.cell"]})
    cell = resolve(bench, "added.cell", here)
    assert "added_ms.layer" in cell.per_layer and cell.driver.__name__.endswith(wl["driver"])
    assert spans_of(cell)[0]["added"] == "osu_dreamer_tpu_torch.nn.norm:rms_norm"
    assert "added_ms.layer" not in resolve(bench, name, here).per_layer
