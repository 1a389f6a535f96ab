"""Hit-signal decoding: 7 per-frame channels -> discrete hit events.

Copy of the decode side of osu_dreamer_tpu/signal/hits.py (the encode side,
``hit_signal`` and ``events_signal``, is not ported yet): peaks of height
0.7 by ``find_peaks``, rising/falling extent pairs at 0.5, flags and extents
attached to the nearest onset within +-2 frames, holds shorter than 4 frames
kept as circles, sustains without a slide as spinners, and ``num_slides =
round(sustain / slide)``.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from .constants import HIT_DIM
from .encoding import Channel

PEAK_HEIGHT = 0.7
ONSET_TOL_FRAMES = 2
MIN_SUSTAIN_FRAMES = 4

# hit(t, new_combo, whistle, finish, clap) or
# hold(t, new_combo, whistle, finish, clap, end, num_slides); num_slides=0 -> spinner
Hit = Union[
    tuple[int, bool, bool, bool, bool],
    tuple[int, bool, bool, bool, bool, int, int],
]


def decode_events(sig: np.ndarray) -> list[int]:
    """frame indices of bump peaks"""
    from scipy.signal import find_peaks

    return find_peaks(sig, height=PEAK_HEIGHT)[0].tolist()


def decode_extents(sig: np.ndarray) -> tuple[list[int], list[int]]:
    """paired (starts, ends) of the 0.5-thresholded intervals"""
    binary = sig > 0.5
    rising = np.flatnonzero(~binary[:-1] & binary[1:]).tolist()
    falling = np.flatnonzero(binary[:-1] & ~binary[1:]).tolist()

    starts: list[int] = []
    ends: list[int] = []
    fi = 0
    for s in rising:
        while fi < len(falling) and falling[fi] <= s:
            fi += 1
        if fi == len(falling):
            break
        starts.append(s)
        ends.append(falling[fi])
        fi += 1
    return starts, ends


def decode_hit_signal(sig: np.ndarray) -> list[Hit]:
    """(7, L) hit signal -> list of hits/holds, matching extent starts and
    property peaks to onsets within +-ONSET_TOL_FRAMES"""
    assert sig.shape[0] == HIT_DIM
    L = sig.shape[1]

    onset_idxs = decode_events(sig[Channel.ONSET])
    n = len(onset_idxs)

    # frame index -> NEAREST onset ordinal within tolerance (-1 elsewhere).
    # Nearest, not last-writer-wins: when onsets sit <= 2*tol apart, a flag
    # peak landing exactly on onset i's frame must attach to i, not i+1
    frame_to_onset = np.full(L, -1, dtype=int)
    frame_dist = np.full(L, ONSET_TOL_FRAMES + 1, dtype=int)
    for ordinal, fi in enumerate(onset_idxs):
        lo = max(fi - ONSET_TOL_FRAMES, 0)
        hi = min(fi + ONSET_TOL_FRAMES + 1, L)
        d = np.abs(np.arange(lo, hi) - fi)
        closer = d < frame_dist[lo:hi]
        frame_to_onset[lo:hi] = np.where(closer, ordinal, frame_to_onset[lo:hi])
        frame_dist[lo:hi] = np.minimum(frame_dist[lo:hi], d)

    flags = np.zeros((n, 4), dtype=bool)
    for col, ch in enumerate((Channel.COMBO, Channel.WHISTLE, Channel.FINISH, Channel.CLAP)):
        for fi in decode_events(sig[ch]):
            ordinal = frame_to_onset[fi]
            if ordinal >= 0:
                flags[ordinal, col] = True

    sustain_end = np.full(n, -1, dtype=int)
    for s, e in zip(*decode_extents(sig[Channel.SUSTAIN])):
        ordinal = frame_to_onset[s]
        if ordinal >= 0:
            sustain_end[ordinal] = e

    slide_end = np.full(n, -1, dtype=int)
    for s, e in zip(*decode_extents(sig[Channel.SLIDE])):
        ordinal = frame_to_onset[s]
        if ordinal >= 0:
            slide_end[ordinal] = e

    hits: list[Hit] = []
    for ordinal, onset in enumerate(onset_idxs):
        base = (onset, *(bool(v) for v in flags[ordinal]))
        s_end = int(sustain_end[ordinal])

        if s_end == -1 or s_end - onset < MIN_SUSTAIN_FRAMES:
            hits.append(base)  # plain circle (or sustain too short to trust)
            continue

        l_end = int(slide_end[ordinal])
        if l_end == -1:
            num_slides = 0  # sustain without slide: spinner
        elif l_end <= onset:
            num_slides = 1  # degenerate (zero-length) slide mark: single slide
        else:
            # a PRESENT slide extent always means slider: the channels are
            # independent model outputs, so slide > 2*sustain would round
            # to 0 and silently misclassify the hold as a spinner
            num_slides = max(1, round((s_end - onset) / (l_end - onset)))
        hits.append((*base, s_end, num_slides))

    return hits
