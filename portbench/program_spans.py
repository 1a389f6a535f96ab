"""What the metrics of the program's own spans share. The port marks its
layers' stages with ``span(name)`` (osu_dreamer_tpu_torch/train/profiling.py):
while a profiler records, each span is a range ``odt.<name>`` in the trace,
which the traced window attributes device time to, and a record in the
program's store, with its host clock. A unit span (``sample``, a predict
batch; ``train.step``) holds the stages of one unit.

A metric reads only where every unit was seen once: as many unit records in
the store as traced units, one range a unit of every span it reads, and one
record a unit of each. A program without the store or the ranges reads
None.
"""

from __future__ import annotations

from .readers import median, note

PREFIX = "odt."


def ranges(*spans: str) -> tuple[str, ...]:
    return tuple(PREFIX + s for s in spans)


def _records():
    try:
        from osu_dreamer_tpu_torch.train import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return read() if read is not None else None


def _seen_once(run, spans) -> bool:
    t = run.trace
    if t is None or t.units <= 0:
        return False
    counts = {s: t.range_count.get(PREFIX + s, 0) for s in spans}
    if any(n != t.units for n in counts.values()):
        note(f"program ranges {counts} in {t.units} traced units; not read")
        return False
    return True


def unit_host_ns(run, unit: str, spans) -> list[int] | None:
    """host ns inside ``spans`` in each traced unit, from the program's store"""
    if not _seen_once(run, spans):
        return None
    records = _records()
    if records is None:
        note("the program keeps no span store; not read")
        return None
    units = [i for i, r in enumerate(records) if r.name == unit and r.parent is None]
    if len(units) != run.trace.units:
        note(f"{len(units)} {unit} records in the store, {run.trace.units} traced units; not read")
        return None
    seen = {u: {s: [] for s in spans} for u in units}
    for r in records:
        if r.unit in seen and r.name in seen[r.unit] and r.end_ns is not None:
            seen[r.unit][r.name].append(r.end_ns - r.start_ns)
    if any(len(ns) != 1 for by_span in seen.values() for ns in by_span.values()):
        note(f"{spans}: not one finished record a {unit}; not read")
        return None
    return [sum(ns[0] for ns in by_span.values()) for by_span in seen.values()]


def host_ms(run, unit: str, spans) -> float | None:
    """median over the traced units of host ms inside ``spans``"""
    per_unit = unit_host_ns(run, unit, spans)
    return median([ns / 1e6 for ns in per_unit]) if per_unit else None


def device_ms(run, unit: str, spans) -> float | None:
    """device ms a traced unit launched inside ``spans``"""
    if unit_host_ns(run, unit, spans) is None:
        return None
    seconds = sum(run.trace.range_s.get(PREFIX + s, 0.0) for s in spans)
    return 1e3 * seconds / run.trace.units if seconds > 0 else None
