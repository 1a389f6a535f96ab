"""Tracing and step timing (counterpart of osu_dreamer_tpu/train/profiling.py):
``device_trace`` records a ``torch.profiler`` trace (CPU and, where there is
a card, CUDA activity) of the enclosed block as a Chrome trace;
``StepTimer`` keeps wall-clock step times, discarding warm-up steps;
``span`` marks a layer's stage (the JAX package's ``annotate``).

A span is off unless a ``torch.profiler`` is recording or ``enable()`` was
called. Off, ``span(name)`` reads two flags and returns a shared no-op
context: it records nothing and opens no ``record_function`` (which costs
microseconds a call even with no profiler running). On, it appends a
``Record`` to an in-memory store (name, thread, parent, unit, host
``perf_counter_ns`` start and end) and adds to its name's call count and
host time; while a profiler records, it also opens the range ``odt.<name>``,
so the span sits in the profiler's trace beside the kernels launched inside
it, on the profiler's clock. A span's unit is the index of the outermost
span open on its thread, so the spans of one sampler batch or one train
step share it; each thread keeps its own stack of open spans (the sharded
sampler and serve run on their own threads). ``records()``, ``totals()``
and ``reset()`` read and clear the store.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler  # _is_profiler_enabled: torch's own flag


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """write ``trace.json`` (chrome://tracing, Perfetto) under ``log_dir``"""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    """host wall-clock step times, the first ``skip_first`` discarded; a
    step's time is the enqueue time unless the caller synchronises"""

    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._times: list[float] = []
        self._seen = 0
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip_first:
                self._times.append(now - self._last)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / float(np.mean(self._times)) if self._times else 0.0


# ---------------------------------------------------------------- spans ----

RANGE_PREFIX = "odt."
STORE_LIMIT = 1 << 20  # records kept; the totals go on counting past it


class Record(NamedTuple):
    """one span: ``parent`` and ``unit`` are indices into ``records()``
    (None at the top, or once the store is full); ``end_ns`` is None while
    the span is open"""

    name: str
    thread: int
    parent: int | None
    unit: int | None
    start_ns: int
    end_ns: int | None


_forced = False
_lock = threading.Lock()
_records: list[Record] = []
_totals: dict[str, list[int]] = {}  # name -> [calls, host ns]
_local = threading.local()


def enable(on: bool = True) -> bool:
    """spans on (or back off) with no profiler recording -> the previous setting"""
    global _forced
    was, _forced = _forced, on
    return was


def reset() -> None:
    """drop every record and total (spans still open on some thread finish
    into the totals only)"""
    with _lock:
        _records.clear()
        _totals.clear()


def records() -> list[Record]:
    """a copy of the store, index for index"""
    with _lock:
        return list(_records)


def totals() -> dict[str, tuple[int, int]]:
    """{name: (calls, host ns)} of every span finished since the last reset"""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _totals.items()}


class _Off:
    """the shared context of a span that is off; as a decorator it wraps the
    function in ``span(name)`` at every call"""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


_OFF: dict[str, _Off] = {}


class _Span(_Off):
    __slots__ = ("index", "start_ns", "range")

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.start_ns = time.perf_counter_ns()
        with _lock:
            i = self.index = len(_records) if len(_records) < STORE_LIMIT else None
            parent, unit = stack[-1] if stack else (None, i)
            if i is not None:
                _records.append(Record(self.name, threading.get_ident(), parent, unit,
                                       self.start_ns, None))
        stack.append((i, unit))
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        return None

    def __exit__(self, *exc) -> bool:
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        _local.stack.pop()
        with _lock:
            t = _totals.setdefault(self.name, [0, 0])
            t[0] += 1
            t[1] += end - self.start_ns
            i = self.index
            if i is not None and i < len(_records) and _records[i].start_ns == self.start_ns:
                _records[i] = _records[i]._replace(end_ns=end)
        return False


def span(name: str):
    """``with span("stage"):`` or ``@span("stage")``: a stage of a layer,
    recorded while a profiler records or after ``enable()``; otherwise a
    shared no-op"""
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF.get(name) or _OFF.setdefault(name, _Off(name))
