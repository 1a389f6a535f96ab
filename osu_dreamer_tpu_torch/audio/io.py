"""Spectrogram disk format: uint8-quantized ``.npy``.

Copy of osu_dreamer_tpu/audio/io.py (that package imports jax;
tests/test_torch_data.py and tests/test_torch_ingest.py pin this copy to
it): the same dtype and rounding, so datasets interchange between the two
packages.
"""

from __future__ import annotations

from typing import BinaryIO

import numpy as np

SPEC_DTYPE = np.uint8


def write_spec(f: BinaryIO, spec: np.ndarray) -> None:
    # clip before quantizing: a value outside [0, 1] would WRAP modulo 256
    # through the uint8 cast (1.01 -> 2) and silently corrupt the dataset
    q = np.clip(spec, 0.0, 1.0) * np.iinfo(SPEC_DTYPE).max + 0.5
    np.save(f, q.astype(SPEC_DTYPE))


def read_spec(f: BinaryIO) -> np.ndarray:
    """(A_DIM, L) uint8 file -> f32 in [0, 1]"""
    return np.load(f).astype(np.float32) / np.float32(np.iinfo(SPEC_DTYPE).max)
