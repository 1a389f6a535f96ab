"""The metrics that read the program's own spans (``odt.<name>`` ranges and
the port's span store, portbench/program_spans.py): each resolves with its
``RANGES``, reads its value from a synthetic trace and store, and reads None
where a count of ranges or unit records is not the traced units'; a tiny
traced run on the CPU reads the host metrics from the program itself."""

from __future__ import annotations

import statistics
import time

import pytest
from conftest import ROOT, tiny

from osu_dreamer_tpu_torch.train import profiling
from osu_dreamer_tpu_torch.train.profiling import Record
from portbench.bench import Run, benchmark, resolve, spans_of
from portbench.cell import Window
from portbench.program_spans import PREFIX
from portbench.run import run_cell
from portbench.trace import Traced

BENCH = benchmark(ROOT)
METRICS = {m["name"]: m for m in BENCH["per_layer"]
           if m["name"].split(".")[0] in ("denoise_ms", "denoise_host_ms", "latent_ms", "fwd_ms",
                                          "fwd_host_ms", "bwd_host_ms", "opt_host_ms")}
UNITS = 3


def metric(name):
    cell = resolve(BENCH, METRICS[name]["workloads"][0])
    return cell, cell.per_layer[name][1]


def unit_of(name):
    return "sample" if name.endswith(".predict") else "train.step"


def spans_read(module):
    return [r[len(PREFIX):] for r in module.RANGES]


def synthetic(name, module, units=UNITS, ranges_a_unit=1, unit_records=UNITS):
    """a Run whose trace holds ``ranges_a_unit`` ranges a unit of each span
    the metric reads, 10 ms + 1 ms x span index of device time each, and
    store records of ``unit_records`` units: the unit span, an unread span,
    and each read span lasting (u + 1) x (its index + 2) ms in unit u"""
    cell, _ = metric(name)
    spans = spans_read(module)
    trace = Traced(units=units)
    trace.range_count = {PREFIX + s: ranges_a_unit * units for s in spans}
    trace.range_s = {PREFIX + s: units * (10 + k) / 1e3 for k, s in enumerate(spans)}
    records, ms = [], 1_000_000
    for u in range(unit_records):
        top = len(records)
        records.append(Record(unit_of(name), 1, None, top, 0, 100 * ms))
        records.append(Record("unread", 1, top, top, 0, 50 * ms))
        for k, s in enumerate(spans):
            records.append(Record(s, 1, top, top, ms, ms + (u + 1) * (k + 2) * ms))
    return Run(cell, 1.0, Window(units=10, seconds=1.0), 1.0, trace), records


@pytest.fixture(params=sorted(METRICS))
def name(request):
    return request.param


def test_the_seven_metrics_are_listed():
    assert len(METRICS) == 7
    for m in METRICS.values():
        assert m["source"] == ("device_trace" if "host" not in m["name"] else "host_clock")
        assert m["moves"] == ("maps_per_min" if m["name"].endswith(".predict")
                              else "train_step_ms_p95")


def test_each_metric_resolves_with_its_ranges(name):
    for cell_name in METRICS[name]["workloads"]:
        cell = resolve(BENCH, cell_name)
        module = cell.per_layer[name][1]
        assert module.RANGES and all(r.startswith(PREFIX) for r in module.RANGES)
        assert set(module.RANGES) <= spans_of(cell)[1]
        assert not getattr(module, "SPANS", {})


def test_each_metric_reads_synthetic_units(name, monkeypatch):
    _, module = metric(name)
    run, records = synthetic(name, module)
    monkeypatch.setattr(profiling, "records", lambda: records)
    spans = spans_read(module)
    if "host" in name:
        want = statistics.median((u + 1) * sum(k + 2 for k in range(len(spans)))
                                 for u in range(UNITS))
    else:
        want = sum(10 + k for k in range(len(spans)))
    assert module.read(run) == pytest.approx(want)


@pytest.mark.parametrize("fault", ["two ranges a unit", "a unit record short",
                                   "a unit record over", "no store", "untraced"])
def test_each_metric_reads_none_where_a_count_differs(name, fault, monkeypatch):
    _, module = metric(name)
    kw = {"two ranges a unit": {"ranges_a_unit": 2},
          "a unit record short": {"unit_records": UNITS - 1},
          "a unit record over": {"unit_records": UNITS + 1}}.get(fault, {})
    run, records = synthetic(name, module, **kw)
    if fault == "no store":
        monkeypatch.delattr(profiling, "records")
    else:
        monkeypatch.setattr(profiling, "records", lambda: records)
    if fault == "untraced":
        run.trace = None
    assert module.read(run) is None


@pytest.mark.parametrize("cell_name", ["predict.mapset-120s", "train.denoiser-l152"])
def test_a_tiny_traced_run_reads_the_host_metrics(cell_name):
    """on the CPU the trace holds no device time, so the device metrics read
    None; the host metrics read the program's own spans"""
    cell = tiny(resolve(BENCH, cell_name))
    profiling.reset()
    try:
        result = run_cell(cell, 2**31 + 7, 0.5, True, "cpu", time.perf_counter())
    finally:
        profiling.reset()
    host = {n for n in METRICS if "host" in n and n in cell.per_layer}
    assert host and host <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] > 0 for n in host)
    assert not {n for n in METRICS if "host" not in n} & set(result["metrics"])
