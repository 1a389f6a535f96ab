"""The harness: everything about a cell is found by name in files.

- ``BENCHMARK.json`` (the checkout's root) lists the cells, the end-to-end
  and per-layer metrics, and which cells report which metric;
- ``workloads/<traffic>.json``: the cell's traffic and its ``driver`` and
  ``config`` (and the limits of its correctness check);
- ``configs/<config>.json``: the model configuration as it is run;
- ``drivers/<driver>.py``: ``build(cfg, wl, seed, device)`` -> a cell
  (cell.py says what a cell does);
- ``metrics/<metric>.py``: ``read(run)`` -> the metric's value or None when
  the run holds nothing for it to read. A per-layer metric may declare
  ``SPANS`` ({span: "module:attribute"}: ranges the traced part wraps
  around ops' entries) and ``RANGES`` (other range names it reads, such as
  an autograd backward node's).

A later change adds a cell, a configuration, a driver or a metric by
adding files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

from .cell import Window
from .trace import Traced

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def workload(name: str, here: Path = HERE) -> dict:
    return load_json(here / "workloads" / f"{name}.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def driver(name: str, here: Path = HERE) -> ModuleType:
    return _module(here / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def metric(name: str, here: Path = HERE) -> ModuleType:
    return _module(here / "metrics" / f"{name}.py", f"portbench_metric_{name.replace('.', '_')}")


def reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclass
class Cell:
    """one entry of ``workloads`` resolved from its files"""

    name: str
    entry: dict
    wl: dict
    cfg: dict
    driver: ModuleType
    end_to_end: dict   # metric name -> (entry, module)
    per_layer: dict


def resolve(bench: dict, name: str, here: Path = HERE) -> Cell:
    entries = {c["name"]: c for c in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r}; cells: {sorted(entries)}")
    entry = entries[name]
    wl = workload(entry["traffic"], here)
    if wl["config"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json names config {entry['config']!r}, "
                         f"its workload file {wl['config']!r}")
    metrics = {kind: {m["name"]: (m, metric(m["name"], here))
                      for m in bench[kind] if reports(m, name)}
               for kind in ("end_to_end", "per_layer")}
    return Cell(name, entry, wl, config(entry["config"], here), driver(wl["driver"], here),
                metrics["end_to_end"], metrics["per_layer"])


@dataclass
class Run:
    """what a metric reads"""

    cell: Cell
    setup_s: float
    window: Window
    flops_per_unit: float
    trace: Traced | None = None


def spans_of(cell: Cell) -> tuple[dict, set]:
    """the spans to wrap and the range names to attribute for the cell's
    per-layer metrics"""
    spans, ranges = {}, set()
    for _, module in cell.per_layer.values():
        spans.update(getattr(module, "SPANS", {}))
        ranges.update(getattr(module, "RANGES", ()))
    return spans, ranges | {f"portbench.{s}" for s in spans}


def read_metrics(metrics: dict, run: Run) -> dict:
    """{name: {"value", "unit"}} of those that found something to read"""
    out = {}
    for name, (entry, module) in metrics.items():
        value = module.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": entry["unit"]}
    return out
