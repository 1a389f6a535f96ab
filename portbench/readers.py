"""What the metric files share: a kernel's share of its roofline over the
calls of one op in the traced window, the model FLOPs utilization, the
device's idle share.
"""

from __future__ import annotations

import sys

from .roofline import BF16_PEAK, bound


def note(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)


def roofline_share(run, span: str, work, launches: str, backward: str | None = None):
    """100 x (least time of the op's calls) / (device time launched inside
    them), in %. ``work(shapes)`` -> (operations, bytes) of one call from its
    argument shapes; ``backward``: time the autograd range of the op's
    backward node instead of the forward's span. None unless every call is
    seen: as many ranges as calls, and as many launches of the counted
    kernel"""
    t = run.trace
    if t is None:
        return None
    calls = t.calls.get(span, [])
    rng = f"portbench.{span}" if backward is None else backward
    n = t.range_count.get(rng, 0)
    if not calls or n != len(calls) or t.launches.get(launches, 0) != n:
        if calls or n:
            note(f"{rng}: {n} ranges, {len(calls)} calls, {t.launches.get(launches, 0)} "
                 f"{launches} launches; not read")
        return None
    seconds = t.range_s.get(rng, 0.0)
    if seconds <= 0:
        return None
    least = sum(bound(*work(shapes))["bound_ms"] for shapes in calls) / 1e3
    return 100.0 * least / seconds


def seconds_per_unit(run) -> float | None:
    """host seconds a unit in the untraced window (the profiler slows the
    host's issue, so the traced window's length is not the run's pace)"""
    w = run.window
    return w.seconds / w.units if w.units else None


def mfu(run):
    """model FLOPs a unit over the untraced window's seconds a unit x the
    bf16 peak, in % (read in the traced run)"""
    per = seconds_per_unit(run)
    if run.trace is None or per is None:
        return None
    return 100.0 * run.flops_per_unit / (per * BF16_PEAK)


def idle_share(run):
    """100 x (1 - device busy a unit in the trace / seconds a unit of the
    untraced window), in %"""
    t, per = run.trace, seconds_per_unit(run)
    if t is None or per is None or t.units <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.units / per)


def median(values):
    if not values:
        return None
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def ranges_time_ms_per_unit(run, spans) -> float | None:
    t = run.trace
    if t is None or t.units <= 0:
        return None
    names = [f"portbench.{s}" for s in spans]
    seconds = sum(t.range_s.get(n, 0.0) for n in names)
    if not all(t.range_count.get(n, 0) for n in names) or seconds <= 0:
        return None
    return 1e3 * seconds / t.units
