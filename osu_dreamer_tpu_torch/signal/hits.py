"""Hit-signal codec: 7 per-frame channels <-> discrete hit events.

Copy of osu_dreamer_tpu/signal/hits.py with the jaxtyping annotations
dropped (tests/test_torch_codec_encode.py and tests/test_torch_serialize.py
pin it to the original).
- Encode: gaussian bumps (sigma 10 ms) max-pooled over event times, each
  touching only the frames within 5 sigma of its event (beyond that the
  bump is below 4e-6, which the uint8 map file rounds to 0); binary
  in-interval extent masks; the 7-row stack.
- Decode: peaks of height 0.7 by ``find_peaks``, rising/falling extent
  pairs at 0.5, flags and extents attached to the nearest onset within +-2
  frames, holds shorter than 4 frames kept as circles, sustains without a
  slide as spinners, and ``num_slides = round(sustain / slide)``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence, Union

import numpy as np

from .constants import HIT_DIM
from .encoding import Channel

if TYPE_CHECKING:
    from ..osu import Beatmap

EVENT_SIGMA_MS = 10.0
PEAK_HEIGHT = 0.7
ONSET_TOL_FRAMES = 2
MIN_SUSTAIN_FRAMES = 4

# hit(t, new_combo, whistle, finish, clap) or
# hold(t, new_combo, whistle, finish, clap, end, num_slides); num_slides=0 -> spinner
Hit = Union[
    tuple[int, bool, bool, bool, bool],
    tuple[int, bool, bool, bool, bool, int, int],
]


# ----------------------------------------------------------------- encoding --


def events_signal(
    ts: Sequence[float],
    frame_times: np.ndarray,
    sigma: float = EVENT_SIGMA_MS,
) -> np.ndarray:
    """gaussian bump (max-pooled) at each event time; windowed to +-5 sigma"""
    sig = np.zeros_like(frame_times)
    if len(ts) == 0:
        return sig

    frame_ms = frame_times[1] - frame_times[0] if len(frame_times) > 1 else 1.0
    halfwidth = max(1, int(np.ceil(5.0 * sigma / frame_ms)))

    ts_arr = np.asarray(ts, dtype=float)
    centers = np.searchsorted(frame_times, ts_arr)
    window = np.arange(-halfwidth, halfwidth + 1)
    idx = np.clip(centers[:, None] + window[None, :], 0, len(frame_times) - 1)
    vals = np.exp(-0.5 * ((ts_arr[:, None] - frame_times[idx]) / sigma) ** 2)
    np.maximum.at(sig, idx.ravel(), vals.ravel())
    return sig


def extents_signal(
    regions: Sequence[tuple[float, float]], frame_times: np.ndarray
) -> np.ndarray:
    """1 on frames with start <= t < end for any region, else 0"""
    sig = np.zeros_like(frame_times)
    for start, end in regions:
        i0 = int(np.searchsorted(frame_times, start, side="left"))
        i1 = int(np.searchsorted(frame_times, end, side="left"))
        sig[i0:i1] = 1.0
    return sig


def hit_signal(bm: "Beatmap", frame_times: np.ndarray) -> np.ndarray:
    """(7, L) stack: onsets / new combos / first-slide / sustains / 3 hit sounds"""
    assert frame_times.ndim == 1, f"frame_times must be 1-D, got {frame_times.shape}"
    from ..osu import Slider, Spinner

    objs = bm.hit_objects
    return np.stack(
        [
            events_signal([o.t for o in objs], frame_times),
            events_signal([o.t for o in objs if o.new_combo], frame_times),
            extents_signal(
                [(o.t, o.t + o.slide_duration) for o in objs if isinstance(o, Slider)],
                frame_times,
            ),
            extents_signal(
                [(o.t, o.end_time()) for o in objs if isinstance(o, (Slider, Spinner))],
                frame_times,
            ),
            events_signal([o.t for o in objs if o.whistle], frame_times),
            events_signal([o.t for o in objs if o.finish], frame_times),
            events_signal([o.t for o in objs if o.clap], frame_times),
        ]
    )


# ----------------------------------------------------------------- decoding --


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
