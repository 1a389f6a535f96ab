"""Metrics logging: TensorBoard scalars and figures through tensorboardX when
it can be imported, else scalars as lines on stderr and no figures
(counterpart of osu_dreamer_tpu/train/logging.py)."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Mapping


class MetricsLogger:
    """``write`` False (a rank other than 0): logs nothing"""

    def __init__(self, run_dir: str | Path, write: bool = True):
        self.run_dir = Path(run_dir)
        self.write = write
        self._writer = None
        if not write:
            return
        self.run_dir.mkdir(parents=True, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self._writer = SummaryWriter(logdir=str(self.run_dir))
        except ImportError:
            self._writer = None

    def scalars(self, values: Mapping[str, Any], step: int, prefix: str = "") -> None:
        if not self.write:
            return
        for name, value in values.items():
            tag = f"{prefix}{name}" if prefix else name
            v = float(value)
            if self._writer is not None:
                self._writer.add_scalar(tag, v, step)
            else:
                print(f"[{step}] {tag} = {v:.5f}", file=sys.stderr)

    def figure(self, tag: str, fig, step: int) -> None:
        """a matplotlib figure under ``tag`` (nothing without tensorboardX)"""
        if self._writer is not None:
            self._writer.add_figure(tag, fig, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
