"""Timing-signal encoder: per-frame beat and measure phase.

Copy of osu_dreamer_tpu/signal/timing.py (tests/test_torch_codec_encode.py
pins it to the original): the first timing point is rewound by whole
measures so its grid covers the start of the song.
"""

from __future__ import annotations

from enum import IntEnum
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..osu import Beatmap


class TimingChannel(IntEnum):
    BEAT_PHASE = 0
    MEASURE_PHASE = 1


TIMING_DIM = len(TimingChannel)


def timing_signal(bm: "Beatmap", frame_times: np.ndarray) -> np.ndarray:
    """(2, L): fractional beat phase and measure phase at each frame"""
    sig = np.zeros((TIMING_DIM, len(frame_times)))

    for i, tp in enumerate(bm.timing_points):
        start = float(tp.t)
        if i == 0:
            # rewind whole measures so the grid covers the song intro
            measure = tp.beat_length * tp.meter
            start -= (start // measure + 1) * measure
        active = frame_times >= start
        beats = (frame_times[active] - start) / tp.beat_length
        sig[TimingChannel.BEAT_PHASE, active] = beats % 1.0
        sig[TimingChannel.MEASURE_PHASE, active] = (beats / tp.meter) % 1.0

    return sig
