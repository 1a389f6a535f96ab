"""The control reads not correct: the reference in fp8 in the program's
place fails a cell's limits. On the CPU at a tiny size; with the ``gpu``
marker at the cell's own size on the card (where the limits were set from
the readings of portbench/calibrate.py)."""

from __future__ import annotations

import pytest
import torch
from conftest import ROOT

from portbench.bench import benchmark, resolve
from portbench.compare import checks


def _control(cell, seed: int, device) -> list:
    c = cell.driver.build(cell.cfg, cell.wl, seed, device)
    c.setup()
    if not hasattr(c, "losses"):
        c.run_units(1)
    readings = c.check(["program", "fp8"])
    return checks(readings["program"], c.limits), checks(readings["fp8"], c.limits)


def test_control_fails_at_a_tiny_size(tiny_cell):
    sound, control = _control(tiny_cell, 2**31 + 31, "cpu")
    assert all(ch.limit is not None for ch in control)
    assert not all(ch.ok for ch in control), control
    worse = [c.value > s.value for s, c in zip(sound, control)]
    assert any(worse)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c["name"] for c in benchmark(ROOT)["workloads"]])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    sound, control = _control(resolve(benchmark(ROOT), name), 2**31 + 32, "cuda")
    assert all(ch.ok for ch in sound), sound
    assert not all(ch.ok for ch in control), control
