"""What every driver's cell gives the harness, and the helpers they share.

A driver (drivers/<name>.py) has ``build(cfg, wl, seed, device)`` returning
a cell with:

- ``setup()``: the program's objects, the weights from the seed, the
  traffic, the warm-up at the cell's shapes (and whatever the correctness
  check needs from the first units);
- ``run(seconds) -> Window``: the closed loop for about ``seconds``, every
  unit it issues completed and counted;
- ``run_units(n)``: n more units, completed (the traced part of a run);
- ``check(kinds=("program",)) -> {kind: {number: value}}``: the compared
  numbers, after the window, the program's state freed: "program" the
  timed path's, "fp8" the control's (the reference in fp8 in the
  program's place), and the cell's planted faults;
- ``items_per_unit``, ``flops_per_unit``, ``syncs`` (the host syncs the
  program's call made in the last warm-up unit) and ``limits`` (the workload's).
"""

from __future__ import annotations

import sys
import time
import warnings
from dataclasses import dataclass, field

import torch


@dataclass
class Window:
    units: int = 0
    items: int = 0
    seconds: float = 0.0
    unit_ms: list[float] = field(default_factory=list)       # device clock, a unit each
    host_issue_ms: list[float] = field(default_factory=list)  # host clock, a unit each


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def count_syncs(device, fn):
    """run ``fn`` with CUDA's sync debug mode warning on every host sync ->
    (its result, the number of syncs; 0 off the card); where each sync was
    called from goes to standard error"""
    if torch.device(device).type != "cuda":
        return fn(), 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and w.filename != torch.cuda.__file__]  # setting the mode back warns once
    for w in syncs:
        print(f"portbench: host sync at {w.filename}:{w.lineno}", file=sys.stderr)
    return out, len(syncs)


def now() -> float:
    return time.perf_counter()


def device_ctx(device):
    """parameters made inside come straight onto ``device``"""
    return torch.device(device)
