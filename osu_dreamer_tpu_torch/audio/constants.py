"""Audio constants, copied from osu_dreamer_tpu/audio/constants.py (that
module's package imports jax; tests/test_torch_modules.py pins each value to
the original).

9 bins/octave x 8 octaves from 32 Hz, sample rate 2*F_MAX = 16384 Hz, a
98-sample (~6 ms) hop.
"""

from __future__ import annotations

import numpy as np

F_MIN = 32
BINS_PER_OCTAVE = 9
N_OCTAVES = 8
N_BINS = N_OCTAVES * BINS_PER_OCTAVE  # 72
A_DIM = N_BINS
F_MAX = F_MIN * (1 << N_OCTAVES)  # 8192
SR = 2 * F_MAX  # 16384 Hz
MS_PER_FRAME = 6
HOP_LEN = (SR * MS_PER_FRAME + 500) // 1000  # 98 samples


def get_frame_times(num_frames: int) -> np.ndarray:
    """millisecond timestamps of the first `num_frames` frames"""
    return np.arange(num_frames) * HOP_LEN / SR * 1000.0


def resonator_freqs() -> np.ndarray:
    """the 72 log-spaced resonator center frequencies (Hz)"""
    return np.geomspace(F_MIN, F_MAX, N_BINS, endpoint=False).astype(np.float32)
