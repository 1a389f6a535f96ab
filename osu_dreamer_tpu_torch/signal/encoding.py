"""Beatmap signal channels and the quantized map file, read side.

Copy of osu_dreamer_tpu/signal/encoding.py ``Channel``, ``HitChannels`` and
``read_beatmap`` (that module imports jaxtyping; tests/test_torch_data.py
pins this copy to it): 9 channels (7 hit + cursor x, y), a map file is an npz of uint8 ``hit``
(7, L), min-max-normalised uint16 ``xy`` (2, L) with ``xy_min``/``xy_rng``
(2, 1), and the 5 ``labels``.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np


class Channel(IntEnum):
    ONSET = 0
    COMBO = 1
    SLIDE = 2
    SUSTAIN = 3
    WHISTLE = 4
    FINISH = 5
    CLAP = 6
    X = 7
    Y = 8


HitChannels = [
    Channel.ONSET,
    Channel.COMBO,
    Channel.SLIDE,
    Channel.SUSTAIN,
    Channel.WHISTLE,
    Channel.FINISH,
    Channel.CLAP,
]

HIT_DTYPE = np.uint8
XY_DTYPE = np.uint16


def read_beatmap(f) -> tuple[np.ndarray, np.ndarray]:
    """-> ((X_DIM, L) float signal, (NUM_LABELS,) labels)"""
    with np.load(f) as npz:
        hit = npz["hit"].astype(float) / np.iinfo(HIT_DTYPE).max
        xy = npz["xy"].astype(float) / np.iinfo(XY_DTYPE).max
        signal = np.concatenate([hit, xy * npz["xy_rng"] + npz["xy_min"]])
        return signal, npz["labels"]
