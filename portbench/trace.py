"""The traced part of a run: ``torch.profiler`` over a few units, and what
the per-layer metrics read from it.

Device time is attributed to an op through the profiler's launch
correlation, not through kernel names: every kernel, copy and set carries
the correlation id of the runtime call that launched it, that call sits on
a host thread at a time, and the op's range (a ``record_function`` range
the benchmark wraps around the op's entry, or the autograd engine's range
of its backward node) holds that time on that thread. A later change that
renames, splits or merges the kernels inside an op leaves the attribution
as it is.

The Chrome trace is written under the run's temporary directory, read
once and deleted.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import tempfile
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation", "cpu_op")
BACKWARD = "autograd::engine::evaluate_function: {}"


def span_name(span: str) -> str:
    return f"portbench.{span}"


def _shape(a):
    if isinstance(a, torch.Tensor):
        return tuple(a.shape)
    return a if isinstance(a, (int, float, str)) else None


class Spans:
    """``record_function`` ranges around ops' entries where the layers call
    them, with each call's argument shapes: {span: "module:attribute"},
    the attribute dotted for a method (``AdamW.step``)"""

    def __init__(self, specs: dict[str, str]):
        self.specs = specs
        self.calls: dict[str, list] = defaultdict(list)
        self._saved = []

    def install(self) -> None:
        for span, spec in self.specs.items():
            module, attr = spec.split(":")
            owner = importlib.import_module(module)
            *path, leaf = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            original = getattr(owner, leaf)
            self._saved.append((owner, leaf, original))
            setattr(owner, leaf, self._wrap(span, original))

    def _wrap(self, span: str, fn):
        calls, name = self.calls[span], span_name(span)

        def wrapped(*args, **kwargs):
            calls.append(tuple(_shape(a) for a in args))
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    def remove(self) -> None:
        for owner, leaf, original in reversed(self._saved):
            setattr(owner, leaf, original)
        self._saved.clear()


@dataclass
class Traced:
    units: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    device_events: int = 0
    unattributed: int = 0
    range_s: dict = field(default_factory=dict)      # range name -> device seconds
    range_count: dict = field(default_factory=dict)  # range name -> ranges in the window
    calls: dict = field(default_factory=dict)        # span -> argument shapes of each call
    launches: dict = field(default_factory=dict)     # kernel counter -> launches in the window
    device_ops: list = field(default_factory=list)   # [name, seconds], the 10 largest
    idle_gaps: list = field(default_factory=list)    # [host activity, seconds], the 10 longest


def _union(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """-> (covered length, merged intervals)"""
    merged: list[list[float]] = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def read_trace(events: list[dict], ranges: set[str]) -> Traced:
    """busy time, attribution to ``ranges`` and the breakdown inside the
    benchmark's window range, from Chrome trace events (times in us)"""
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window ranges, not 1")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    host_tid = win[0].get("tid")
    out = Traced(window_s=(w1 - w0) / 1e6)

    launches = {}
    by_range = defaultdict(list)   # (tid, name) -> [(start, stop)]
    host = []                      # what the window's thread ran: (start, stop, name)
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, stop = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), start)
        if cat in RANGE_CATS and e.get("name") in ranges and w0 <= start <= w1:
            by_range[(e.get("tid"), e["name"])].append((start, stop))
        if cat in RANGE_CATS + LAUNCH_CATS and e.get("tid") == host_tid and e["name"] != WINDOW:
            host.append((start, stop, e["name"]))
    for key in by_range:
        by_range[key].sort()
    starts = {key: [s for s, _ in v] for key, v in by_range.items()}
    out.range_count = defaultdict(int)
    for (_, name), v in by_range.items():
        out.range_count[name] += len(v)
    out.range_s = defaultdict(float)

    busy, by_op = [], defaultdict(float)
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        start = max(float(e["ts"]), w0)
        stop = min(float(e["ts"]) + float(e["dur"]), w1)
        if stop <= start:
            continue
        out.device_events += 1
        busy.append((start, stop))
        by_op[e["name"][:160]] += (stop - start) / 1e6
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            out.unattributed += 1
            continue
        tid, t = launch
        for (rtid, name), v in by_range.items():
            if rtid != tid:
                continue
            i = bisect.bisect_right(starts[(rtid, name)], t) - 1
            if i >= 0 and v[i][0] <= t <= v[i][1]:
                out.range_s[name] += (stop - start) / 1e6
    covered, merged = _union(busy)
    out.busy_s = covered / 1e6
    out.device_ops = sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:10]
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host.sort()
    for length, at in gaps:
        active = [h for h in host if h[0] <= at <= h[1]]
        what = max(active)[2][:120] if active else "host between ops"
        out.idle_gaps.append([what, length / 1e6])
    out.range_s, out.range_count = dict(out.range_s), dict(out.range_count)
    return out


@contextmanager
def profiled(device):
    """a profiler over the body inside the window range; -> a list that holds
    the trace's events once the body has ended"""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    events: list = []
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield events
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events.extend(json.loads(Path(path).read_text())["traceEvents"])
    finally:
        os.unlink(path)
