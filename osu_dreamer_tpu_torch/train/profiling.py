"""Tracing and step timing (counterpart of osu_dreamer_tpu/train/profiling.py):
``device_trace`` records a ``torch.profiler`` trace (CPU and, where there is
a card, CUDA activity) of the enclosed block as a Chrome trace;
``StepTimer`` keeps wall-clock step times, discarding warm-up steps."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


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
