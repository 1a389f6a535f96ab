"""Shared set-up of the benchmark's CPU tests: the checkout's root on the
path, and the cells cut to a size a CPU test holds (every width smaller,
lengths of a few latent frames), so the drivers run their internal
functions on CPU tensors."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import benchmark, resolve  # noqa: E402

CELLS = [c["name"] for c in benchmark(ROOT)["workloads"]]


def tiny(cell):
    """the cell at a CPU test's size: narrower models, 2 songs x 2 rows of
    one wave bucket, 3 sampler steps; train batches of 4 x 16"""
    cell = dataclasses.replace(cell, cfg=copy.deepcopy(cell.cfg), wl=copy.deepcopy(cell.wl))
    cfg, wl = cell.cfg, cell.wl
    cfg["diffusion"].update(backbone_dim=128, global_cond_dim=64, a_dim=32, u_head_dim=16)
    cfg["diffusion"]["backbone"].update(depth=2, n_heads=2, head_dim=32)
    if "latent" in cfg:
        cfg["latent"].update(h_dim=32, style_head_dim=16, style_heads=2)
        cfg["latent"]["stack"].update(n_layers=2)
        cfg["style"].update(h_dim=64, depth=2, label_features=16)
        cfg["sampling"].update(steps=3)
        wl.update(songs=2, song_seconds=2.0, difficulties=2, pool=2, warmup_units=1,
                  trace_units=1)
    else:
        wl.update(batch=4, seq_len=16, pool=4, trace_units=2)
    return cell


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param


@pytest.fixture
def tiny_cell(cell_name):
    return tiny(resolve(benchmark(ROOT), cell_name))
