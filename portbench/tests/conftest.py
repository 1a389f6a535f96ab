"""Shared set-up of the benchmark's CPU tests: the checkout's root on the
path, and the cells cut to a size a CPU test holds, so the drivers run their
internal functions on CPU tensors. Each cell's cut is data: the ``"cpu"``
block of its workload file, ``{"config": {...}, "workload": {...}}``, merged
into the resolved configuration and workload (nested groups key by key).
The harness's run never reads that block."""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.bench import benchmark, resolve  # noqa: E402

# the tests run under several workers (-n 4): a few threads each, not every
# core each
torch.set_num_threads(min(torch.get_num_threads(), 2))

CELLS = [c["name"] for c in benchmark(ROOT)["workloads"]]


def merged(base: dict, over: dict) -> dict:
    """a copy of ``base`` with ``over``'s keys set, nested dicts merged"""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def tiny(cell):
    """the cell at a CPU test's size, cut by its workload file's "cpu" block"""
    if "cpu" not in cell.wl:
        raise KeyError(f"{cell.name}: its workload file has no \"cpu\" block to cut it by")
    cut = cell.wl["cpu"]
    return dataclasses.replace(cell, cfg=merged(cell.cfg, cut.get("config", {})),
                               wl=merged(cell.wl, cut.get("workload", {})))


def faults_of(driver: str) -> list:
    """the faults that a cell of ``driver`` can have: the ``FAULTS`` list of
    ``faults/<driver>.py`` beside this file, each planted with pytest's
    ``monkeypatch``"""
    path = Path(__file__).parent / "faults" / f"{driver}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_faults_{driver}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return list(module.FAULTS)


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param


@pytest.fixture
def tiny_cell(cell_name):
    return tiny(resolve(benchmark(ROOT), cell_name))
