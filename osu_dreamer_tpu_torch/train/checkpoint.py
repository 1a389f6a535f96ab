"""Checkpoints: best-by-metric plus a rolling ``last``, with exact resume.

Counterpart of osu_dreamer_tpu/train/checkpoint.py. A checkpoint directory
holds ``state.pt`` (``torch.save`` of ``TrainState.state_dict()``: step,
params, optimizer moments, EMA params, generator state) and ``meta.json``
(hyperparameters, the monitored metric, the data-stream position). A save
writes a sibling ``.tmp`` directory and swaps it in with renames, so an
interrupt mid-save never destroys the previous resume point.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import torch

from .state import TrainState

_STATE_FILE = "state.pt"
_META_FILE = "meta.json"


def save_train_checkpoint(
    path: str | Path,
    state: TrainState | dict,
    hparams: dict[str, Any],
    metric: Optional[float] = None,
    progress: Optional[dict[str, int]] = None,
) -> None:
    """write a full training checkpoint of ``state`` (a TrainState or its
    ``state_dict()``; replaces ``path``)"""
    state_dict = state if isinstance(state, dict) else state.state_dict()
    path = Path(path).absolute()
    tmp = path.with_name(path.name + ".tmp")
    old = path.with_name(path.name + ".old")
    for stale in (tmp, old):
        if stale.exists():
            shutil.rmtree(stale)
    tmp.mkdir(parents=True)
    torch.save(state_dict, tmp / _STATE_FILE)
    meta = {"hparams": hparams, "metric": metric, "step": state_dict["step"]}
    if progress is not None:
        # the epoch to restart in and how many of its batches were consumed
        # (streams are deterministic per epoch: seeded with seed + epoch)
        meta["progress"] = progress
    (tmp / _META_FILE).write_text(json.dumps(meta))
    if path.exists():
        path.rename(old)
    tmp.rename(path)
    if old.exists():
        shutil.rmtree(old)


def restore_train_state(path: str | Path, state: TrainState) -> TrainState:
    """load a checkpoint into ``state`` (in place) -> state"""
    saved = torch.load(Path(path).absolute() / _STATE_FILE, map_location="cpu", weights_only=True)
    state.load_state_dict(saved)
    return state


def load_train_checkpoint(path: str | Path, map_location: torch.device | str = "cpu"
                          ) -> tuple[dict, dict[str, Any]]:
    """a checkpoint directory -> (``TrainState.state_dict()`` as saved, on
    ``map_location``; its hyperparameters)"""
    path = Path(path).absolute()
    state = torch.load(path / _STATE_FILE, map_location=map_location, weights_only=True)
    return state, json.loads((path / _META_FILE).read_text())["hparams"]


def read_progress(path: str | Path) -> dict[str, int]:
    """data-stream position stored with a checkpoint (empty when saved
    without it)"""
    meta_file = Path(path).absolute() / _META_FILE
    if not meta_file.exists():
        return {}
    return json.loads(meta_file.read_text()).get("progress") or {}


class BestCheckpointKeeper:
    """the single best checkpoint by a monitored metric plus a rolling
    ``last`` for resume (saved at most every ``min_save_interval_s``; a new
    best always saves). ``write`` False (a rank other than 0): tracks the
    best metric and writes nothing"""

    def __init__(self, run_dir: str | Path, monitor: str, mode: str = "min",
                 min_save_interval_s: float = 0.0, write: bool = True):
        if mode not in ("min", "max"):
            raise ValueError(f"monitor mode must be min or max, got {mode!r}")
        self.run_dir = Path(run_dir)
        self.monitor, self.mode = monitor, mode
        self.min_save_interval_s = min_save_interval_s
        self.write = write
        self._last_save_t = -float("inf")
        self.best_metric: Optional[float] = None
        best_meta = self.best_path / _META_FILE
        if best_meta.exists():
            self.best_metric = json.loads(best_meta.read_text()).get("metric")

    @property
    def best_path(self) -> Path:
        return self.run_dir / "best"

    @property
    def last_path(self) -> Path:
        return self.run_dir / "last"

    def update(self, state: TrainState | dict, hparams: dict[str, Any],
               metrics: dict[str, float], progress: Optional[dict[str, int]] = None) -> bool:
        """save ``last`` (rate-limited); promote it to ``best`` when the
        monitored metric improves -> whether a new best was saved"""
        value = metrics.get(self.monitor)
        improved = value is not None and (
            self.best_metric is None
            or (self.mode == "min" and value < self.best_metric)
            or (self.mode == "max" and value > self.best_metric)
        )
        now = time.monotonic()
        if not self.write:
            if improved:
                self.best_metric = value
            return improved
        if not improved and now - self._last_save_t < self.min_save_interval_s:
            return False
        save_train_checkpoint(self.last_path, state, hparams, value, progress)
        self._last_save_t = now
        if improved:
            self.best_metric = value
            if self.best_path.exists():
                shutil.rmtree(self.best_path)
            # hardlinks: saves never modify a file in place
            try:
                shutil.copytree(self.last_path, self.best_path, copy_function=os.link)
            except OSError:
                shutil.copytree(self.last_path, self.best_path)
        return improved
