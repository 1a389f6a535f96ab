"""Beatmap signal channels and the quantized map file.

Copy of osu_dreamer_tpu/signal/encoding.py with the jaxtyping annotations
dropped (tests/test_torch_data.py and tests/test_torch_codec_encode.py pin
it to the original): 9 channels (7 hit + cursor x, y); a map file is an npz
of uint8 ``hit`` (7, L), min-max-normalised uint16 ``xy`` (2, L) with
``xy_min``/``xy_rng`` (2, 1), and the 5 ``labels`` (sr, ar, od, cs, hp).
``write_beatmap`` refuses a signal or labels holding NaN.
"""

from __future__ import annotations

from enum import IntEnum
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..osu import Beatmap


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


def get_labels(bm: "Beatmap") -> np.ndarray:
    return np.array([bm.sr, bm.ar, bm.od, bm.cs, bm.hp])


def _reject_nan(x: np.ndarray, what: str) -> np.ndarray:
    if np.isnan(x).any():
        raise ValueError(f"{what} contains nan")
    return x


def write_beatmap(f, bm: "Beatmap", frame_times: np.ndarray) -> None:
    """encode + quantize a beatmap to one npz: uint8 hit signals, min-max
    normalized uint16 cursor + (xy_min, xy_rng) dequantization params, labels"""
    from .cursor import cursor_signal
    from .hits import hit_signal

    hit = _reject_nan(hit_signal(bm, frame_times), "hit signal")
    xy = _reject_nan(cursor_signal(bm, frame_times), "cursor signal")

    xy_min = xy.min(axis=1, keepdims=True)
    xy_rng = xy.max(axis=1, keepdims=True) - xy_min
    xy_rng[xy_rng == 0.0] = 1.0

    np.savez(
        f,
        allow_pickle=False,
        hit=np.round(hit * np.iinfo(HIT_DTYPE).max).astype(HIT_DTYPE),
        xy=np.round((xy - xy_min) / xy_rng * np.iinfo(XY_DTYPE).max).astype(XY_DTYPE),
        xy_min=xy_min,
        xy_rng=xy_rng,
        labels=_reject_nan(get_labels(bm), "labels"),
    )


def read_beatmap(f) -> tuple[np.ndarray, np.ndarray]:
    """-> ((X_DIM, L) float signal, (NUM_LABELS,) labels)"""
    with np.load(f) as npz:
        hit = npz["hit"].astype(float) / np.iinfo(HIT_DTYPE).max
        xy = npz["xy"].astype(float) / np.iinfo(XY_DTYPE).max
        signal = np.concatenate([hit, xy * npz["xy_rng"] + npz["xy_min"]])
        return signal, npz["labels"]
