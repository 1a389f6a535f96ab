"""Every cell, configuration, driver and metric of BENCHMARK.json resolves
from its files by name, and a cell and a metric added as files alone are
picked up, a configuration of another shape with them; each cell's CPU cut
is its workload file's "cpu" block and nothing else."""

from __future__ import annotations

import json
import shutil

import pytest
from conftest import ROOT, faults_of, tiny

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


def test_every_cell_has_its_faults(cell_name):
    """each cell's driver brings the faults its fault test plants:
    ``tests/faults/<driver>.py``, a ``FAULTS`` list that is not empty"""
    faults = faults_of(resolve(BENCH, cell_name).wl["driver"])
    assert faults and all(callable(f) for f in faults)


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


# a configuration of another shape: no diffusion block, a driver of its own,
# and the workload's "cpu" block that cuts it for the CPU tests
NEW_CONFIG = {"name": "added-wae", "source": "https://github.com/jaswon/osu-dreamer",
              "latent": {"h_dim": 128, "stack": {"n_layers": 8, "expand": 4}}, "reduced": []}
NEW_MIX = {"config": "added-wae", "driver": "added_step", "batch": 32,
           "cpu": {"config": {"latent": {"h_dim": 16, "stack": {"n_layers": 2}}},
                   "workload": {"batch": 2}}}


def _copy(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return here


@pytest.mark.parametrize("name", ["predict.mapset-120s", "train.denoiser-l152", "added-wae"])
def test_a_cell_and_a_metric_added_as_files(tmp_path, name):
    """a copy of the benchmark's folder plus one workload file and one metric
    file (for a configuration of another shape also its configuration and
    driver files), and the entries naming them: the new cell and metric
    resolve, and the CPU tests' cut is the workload's own"""
    here = _copy(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    if name == NEW_CONFIG["name"]:
        (here / "configs" / f"{name}.json").write_text(json.dumps(NEW_CONFIG))
        (here / "drivers" / "added_step.py").write_text(
            "def build(cfg, wl, seed, device):\n    raise NotImplementedError\n")
        bench["configs"].append({"name": name, "source": NEW_CONFIG["source"],
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "a test"})
        wl = NEW_MIX
    else:
        wl = json.loads((here / "workloads" / f"{name}.json").read_text())
    (here / "workloads" / "added.mix.json").write_text(json.dumps(wl))
    (here / "metrics" / "added_ms.layer.py").write_text(
        "SPANS = {'added': 'osu_dreamer_tpu_torch.nn.norm:rms_norm'}\n"
        "def read(run):\n    return 1.0\n")
    bench["workloads"].append({"name": "added.cell", "config": wl["config"],
                               "traffic": "added.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "added_ms.layer", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "setup_s", "workloads": ["added.cell"]})
    cell = resolve(bench, "added.cell", here)
    assert "added_ms.layer" in cell.per_layer and cell.driver.__name__.endswith(wl["driver"])
    assert spans_of(cell)[0]["added"] == "osu_dreamer_tpu_torch.nn.norm:rms_norm"
    small = tiny(cell)
    assert small.wl["cpu"] == cell.wl["cpu"] and small.entry == cell.entry
    if name == NEW_CONFIG["name"]:
        assert "diffusion" not in cell.cfg and cell.cfg == NEW_CONFIG
        assert small.cfg["latent"] == {"h_dim": 16, "stack": {"n_layers": 2, "expand": 4}}
        assert small.wl["batch"] == 2 and cell.wl["batch"] == 32
    else:
        assert "added_ms.layer" not in resolve(bench, name, here).per_layer
        assert small.cfg["diffusion"]["backbone"]["depth"] == 2


def test_the_cpu_block_is_all_that_a_cell_gains(tmp_path, cell_name):
    """a cell resolves the same with its workload's "cpu" block as without it,
    but for that key"""
    here = _copy(tmp_path)
    traffic = {c["name"]: c["traffic"] for c in BENCH["workloads"]}[cell_name]
    path = here / "workloads" / f"{traffic}.json"
    wl = json.loads(path.read_text())
    with_block = resolve(BENCH, cell_name, here)
    assert "cpu" in wl and with_block.wl["cpu"] == wl["cpu"]
    del wl["cpu"]
    path.write_text(json.dumps(wl))
    without = resolve(BENCH, cell_name, here)
    assert {k: v for k, v in with_block.wl.items() if k != "cpu"} == without.wl
    assert with_block.cfg == without.cfg and with_block.entry == without.entry
    assert with_block.driver.__file__ == without.driver.__file__
    for kind in ("end_to_end", "per_layer"):
        assert list(getattr(with_block, kind)) == list(getattr(without, kind))
    with pytest.raises(KeyError, match="cpu"):
        tiny(without)
