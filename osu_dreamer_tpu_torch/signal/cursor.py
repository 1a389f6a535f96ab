"""Cursor-signal encoder: per-frame playfield-normalised cursor position.

Copy of osu_dreamer_tpu/signal/cursor.py with the jaxtyping annotations
dropped (tests/test_torch_codec_encode.py pins it to the original): slider
following with repeat reflection, spinners pinned to the playfield centre,
a linear approach to the next object starting ``preempt = 1200 + (120|150)
* (5 - AR)`` ms before it, output divided by the 512 x 384 playfield. Each
object touches only its own frame range (searchsorted into the uniform
frame grid).
"""

from __future__ import annotations

import warnings
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from ..osu import Beatmap

PLAYFIELD = np.array([512.0, 384.0])


def preempt_ms(ar: float) -> float:
    """approach-rate preempt window (ms): how long an object is on screen"""
    return 1200.0 + (120.0 if ar <= 5 else 150.0) * (5.0 - ar)


def cursor_signal(bm: "Beatmap", frame_times: np.ndarray) -> np.ndarray:
    """(2, L) cursor position in [0,1]^2 (origin bottom-left of playfield)"""
    from ..osu import Circle, Slider, Spinner

    if not bm.hit_objects:
        warnings.warn("beatmap has no hit objects")

    preempt = preempt_ms(bm.ar)

    # virtual starting object at the playfield center
    objs = [Circle(0, True, 0, 256, 192), *bm.hit_objects]

    out = np.zeros((len(frame_times), 2))

    def frames_in(start: float, end: float) -> slice:
        """frame indices with start <= t < end"""
        return slice(
            int(np.searchsorted(frame_times, start, side="left")),
            int(np.searchsorted(frame_times, end, side="left")),
        )

    for i, cur in enumerate(objs):
        nxt = objs[i + 1] if i + 1 < len(objs) else None
        cur_end_t = cur.end_time()

        # while the object is active
        active = frames_in(cur.t, cur_end_t)
        if isinstance(cur, Spinner):
            out[active] = cur.start_pos()
        elif isinstance(cur, Slider):
            phase = ((frame_times[active] - cur.t) / cur.slide_duration) % 2.0
            out[active] = cur.pos_at(np.where(phase < 1.0, phase, 2.0 - phase))
        # circles occupy a single instant; nothing to fill

        end_pos = cur.end_pos()
        if nxt is None:
            out[frames_in(cur_end_t, np.inf)] = end_pos
            break

        # rest at the end position until the next object appears...
        approach_t = max(cur_end_t, nxt.t - preempt)
        out[frames_in(cur_end_t, approach_t)] = end_pos

        # ...then glide linearly to its start
        gliding = frames_in(approach_t, nxt.t)
        frac = (frame_times[gliding] - approach_t) / (nxt.t - approach_t)
        out[gliding] = end_pos + frac[:, None] * (nxt.start_pos() - end_pos)

    return (out / PLAYFIELD).T
