"""A run whose timed path is broken underneath reads ``correct`` false: each
fault a cell can have, planted in the program at a tiny size on the CPU,
driven through the rest of a run (``run_cell``) and judged by the cell's
own limits. The same tiny run without a fault reads correct. A driver's
faults are the ``FAULTS`` list of ``faults/<driver>.py`` beside this file,
so a driver added as files brings its own."""

from __future__ import annotations

import time

import pytest
from conftest import CELLS, ROOT, faults_of, tiny

from portbench.bench import benchmark, resolve
from portbench.run import run_cell


CASES = [(name, fault) for name in CELLS
         for fault in faults_of(resolve(benchmark(ROOT), name).wl["driver"])]


def _run(cell):
    return run_cell(cell, 2**31 + 21, 0.1, False, "cpu", time.perf_counter())


_SOUND: dict = {}


def _sound(name: str) -> dict:
    """the same tiny run without a fault (the CPU's plain bf16 path, so its
    numbers need not meet the card's limits)"""
    if name not in _SOUND:
        _SOUND[name] = _run(tiny(resolve(benchmark(ROOT), name)))["checks"]
    return _SOUND[name]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_reads_incorrect(monkeypatch, name, fault):
    """the fault fails the run, and by a number that the sound run meets"""
    sound = _sound(name)
    fault(monkeypatch)
    result = _run(tiny(resolve(benchmark(ROOT), name)))
    assert not result["correct"], (fault.__name__, result["checks"])
    flipped = [k for k, c in result["checks"].items()
               if c["value"] > c["limit"] >= sound[k]["value"]]
    assert flipped, (fault.__name__, result["checks"], sound)
