"""Spectrogram disk format, read side: uint8-quantized ``.npy``.

Copy of osu_dreamer_tpu/audio/io.py ``read_spec`` (that package imports jax;
tests/test_torch_data.py pins this copy to it).
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

SPEC_DTYPE = np.uint8


def read_spec(f: BinaryIO) -> np.ndarray:
    """(A_DIM, L) uint8 file -> f32 in [0, 1]"""
    return np.load(f).astype(np.float32) / np.float32(np.iinfo(SPEC_DTYPE).max)
