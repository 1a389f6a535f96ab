"""The benchmark of osu_dreamer_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card (without one it
exits nonzero and prints no result). A run builds or loads the port's
kernel library, draws the weights and the traffic on the card from the
seed, warms up at the cell's shapes (all of that is ``setup_s``), runs the
cell's closed loop for about ``--seconds``, and then checks what the timed
path produced against the plain reference. With ``--trace 1`` a few more
units run under torch.profiler and the per-layer metrics are read from
that trace; otherwise the end-to-end metrics are reported. The last line
of standard output is the result as one JSON object; the numbers the check
compared, each beside its limit, are the last lines of standard error and
the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "osu_dreamer_tpu")


def forbidden_modules() -> list[str]:
    """loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's"""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """set up, measure, trace, check -> the result (without ``device``)"""
    import torch

    from portbench.bench import Run, read_metrics, spans_of
    from portbench.compare import checks
    from portbench.trace import Spans, profiled, read_trace

    c = cell.driver.build(cell.cfg, cell.wl, seed, device)
    c.setup()
    setup_s = time.perf_counter() - t_start
    window = c.run(seconds)
    if len(window.host_issue_ms) >= 2:
        q = statistics.quantiles(window.host_issue_ms, n=10)
        print(f"portbench: {window.units} units in {window.seconds:.3f} s; host issue ms "
              f"p10 {q[0]:.3f} p50 {statistics.median(window.host_issue_ms):.3f} p90 {q[-1]:.3f}",
              file=sys.stderr)
    run = Run(cell, setup_s, window, c.flops_per_unit)
    if trace:
        from osu_dreamer_tpu_torch.ops import _build

        spec, ranges = spans_of(cell)
        spans = Spans(spec)
        before = dict(_build.launches)
        spans.install()
        try:
            with profiled(device) as events:
                units = c.run_units(cell.wl["trace_units"])
        finally:
            spans.remove()
        run.trace = read_trace(events, ranges)
        del events
        run.trace.units = units
        run.trace.calls = {k: list(v) for k, v in spans.calls.items()}
        run.trace.launches = {k: v - before.get(k, 0) for k, v in _build.launches.items()}
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    compared = checks(c.check()["program"], c.limits)
    result = {
        "correct": all(ch.ok for ch in compared),
        "attempted": (window.units + (run.trace.units if trace else 0)) * c.items_per_unit,
        "failed": 0,
        "metrics": metrics,
        "memory_peak_bytes": peak,
        "host_syncs_per_unit": c.syncs,
    }
    if trace:
        result["busy_s"] = run.trace.busy_s
        result["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
        result["trace_events"] = run.trace.device_events
    result["checks"] = {ch.name: {"value": ch.value, "limit": ch.limit} for ch in compared}
    return result


def result_line(result: dict, kind: str, count: int, trace: bool) -> dict:
    """the run's last line of standard output: correct, attempted, failed, metrics,
    device (busy_s and window_s when traced), the traced breakdown, two
    keys of this harness, and the compared numbers last"""
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"],
           "device": {"platform": "gpu", "kind": kind, "count": count,
                      "memory_peak_bytes": result["memory_peak_bytes"]}}
    if trace:
        out["device"].update(busy_s=result["busy_s"], window_s=result["window_s"])
        out["breakdown"] = result["breakdown"]
        out["trace_events"] = result["trace_events"]
    out["host_syncs_per_unit"] = result["host_syncs_per_unit"]
    out["checks"] = result["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    from portbench.bench import benchmark, resolve

    cell = resolve(benchmark(ROOT), a.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)  # one process, few threads: the host issues the launches
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {found}", file=sys.stderr)
        return 3
    out = result_line(result, torch.cuda.get_device_name(device), chips, bool(a.trace))
    for name, ch in result["checks"].items():
        print(f"check {name} = {ch['value']!r} (limit {ch['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
