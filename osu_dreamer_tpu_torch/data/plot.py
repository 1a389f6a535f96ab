"""Validation figures: the spectrogram and rows of signals, for TensorBoard.

Copy of osu_dreamer_tpu/data/plot.py (``plot_signals``, ``_n_rows``): one
figure of the spectrogram as an image and a line-plot panel per signal
group, the time axis split across rows for a figure of about 3:5 (height to
width). matplotlib is imported when a figure is drawn, never with this
module: a machine without it trains all the same and skips the figure.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Sequence

import numpy as np

# display-size heuristic: one panel is ~1 unit tall and frames render at
# ~1/150 unit wide; rows are chosen so height/width ~ 3/5
_FRAMES_PER_UNIT = 150.0
_TARGET_ASPECT = 3.0 / 5.0


def _n_rows(n_frames: int, n_panels: int) -> int:
    best, best_err = 1, float("inf")
    for rows in range(1, 9):
        width = n_frames / rows / _FRAMES_PER_UNIT
        aspect = rows * n_panels / max(width, 1e-6)
        err = abs(np.log(aspect / _TARGET_ASPECT))
        if err < best_err:
            best, best_err = rows, err
    return best


@contextmanager
def plot_signals(audio: np.ndarray, signals: Sequence[np.ndarray]) -> Iterator:
    """render ``audio (A, L)`` and each ``(C, L)`` signal group; yields the
    matplotlib figure and closes it on exit (figures leak agg buffers in
    long validation loops otherwise)"""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    audio = np.asarray(audio)
    n_frames = audio.shape[1]
    n_panels = 1 + len(signals)
    rows = _n_rows(n_frames, n_panels)
    per_row = -(-n_frames // rows)

    fig, axs = plt.subplots(
        rows * n_panels,
        1,
        figsize=(min(per_row / _FRAMES_PER_UNIT, 40.0) + 2.0, rows * n_panels * 1.2),
        squeeze=False,
        sharex=False,
    )
    axs = axs[:, 0]

    for r in range(rows):
        sl = slice(r * per_row, min((r + 1) * per_row, n_frames))
        x = np.arange(sl.start, sl.stop)
        ax_spec = axs[r * n_panels]
        ax_spec.imshow(
            audio[:, sl],
            origin="lower",
            aspect="auto",
            interpolation="nearest",
            extent=(sl.start, sl.stop, 0, audio.shape[0]),
        )
        ax_spec.set_yticks(())
        for g, sig in enumerate(signals):
            ax = axs[r * n_panels + 1 + g]
            for ch in np.asarray(sig)[:, sl]:
                ax.plot(x, ch, linewidth=0.6)
            ax.set_xlim(sl.start, max(sl.stop, sl.start + 1))
            ax.set_yticks(())

    fig.tight_layout(pad=0.3)
    try:
        yield fig
    finally:
        plt.close(fig)
