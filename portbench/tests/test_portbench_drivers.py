"""Each driver at a tiny size on CPU tensors, through its own functions and
through ``run_cell``, and the last line's keys."""

from __future__ import annotations

import math
import time

import pytest

from portbench.run import forbidden_modules, result_line, run_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_driver_units_window_and_check(tiny_cell):
    c = tiny_cell.driver.build(tiny_cell.cfg, tiny_cell.wl, 2**31 + 5, "cpu")
    c.setup()
    assert c.flops_per_unit > 0 and c.items_per_unit > 0 and c.syncs == 0
    win = c.run(0.2)
    assert win.units >= 1 and win.items == win.units * c.items_per_unit
    assert len(win.host_issue_ms) >= win.units and win.seconds >= 0.2
    assert c.run_units(1) == 1
    readings = c.check(["program"])["program"]
    assert readings and all(math.isfinite(v) and v >= 0 for v in readings.values())


@pytest.mark.parametrize("trace", [False, True])
def test_run_cell_result(tiny_cell, trace):
    # long enough for the 20 steps a train cell's step-time tail needs
    result = run_cell(tiny_cell, 2**31 + 6, 3.0, trace, "cpu", time.perf_counter())
    reported = tiny_cell.per_layer if trace else tiny_cell.end_to_end
    assert set(result["metrics"]) <= set(reported)
    if not trace:
        assert "setup_s" in result["metrics"] and len(result["metrics"]) >= 2
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    line = result_line(result, "cpu", 1, trace)
    assert list(line)[:5] == CONTRACT_KEYS and list(line)[-1] == "checks"
    assert set(line) - set(CONTRACT_KEYS) == ({"breakdown", "trace_events"} if trace else set()) \
        | {"host_syncs_per_unit", "checks"}
    want = {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    assert set(line["device"]) == want
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    for name in ("osu_dreamer_tpu_torch_x", "jaxtyping", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "osu_dreamer_tpu.models", types.ModuleType("m"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax", "osu_dreamer_tpu"]
