"""Tempo (timing-point) inference from the predicted onset signal.

Copy of osu_dreamer_tpu/signal/tempo.py (numpy only). Comb scoring over the
beat periods of 60-300 BPM on the onset envelope's autocorrelation, a mild
preference for 120-220 BPM, the fastest period within 5 % of the best score,
then a joint sub-frame refinement of period and phase across octaves.
``estimate_tempo_segments`` finds tempo changes from 20 s windows, merges
agreeing neighbours and places each boundary by the onset mass the two
grids explain.
"""

from __future__ import annotations

import math

import numpy as np

MIN_BPM = 60.0
MAX_BPM = 300.0
PREFERRED_LO, PREFERRED_HI = 120.0, 220.0


def octave_ratio_error(a: float, b: float) -> float:
    """|ratio - 1| of a/b after folding into the octave band [0.75, 1.5):
    0 when the two periods (or BPMs) agree modulo halving/doubling"""
    r = a / b
    while r < 0.75:
        r *= 2.0
    while r >= 1.5:
        r /= 2.0
    return abs(r - 1.0)


def _comb_beat_len(onsets: np.ndarray, frame_ms: float) -> float | None:
    """comb-autocorrelation beat length (ms) of an onset envelope, octave-
    shifted into the playable BPM range; None when the span is too short or
    silent"""
    if len(onsets) < 8 or onsets.max() <= 0:
        return None

    env = onsets.astype(np.float64)
    env = env - env.mean()
    env = np.maximum(env, 0.0)

    # candidate beat periods in frames
    min_period = max(2, int(60000.0 / MAX_BPM / frame_ms))
    max_period = min(len(env) // 4, int(60000.0 / MIN_BPM / frame_ms))
    if max_period <= min_period:
        return None

    # autocorrelation via FFT (comb base score)
    n = int(2 ** np.ceil(np.log2(2 * len(env))))
    spectrum = np.fft.rfft(env, n)
    acf = np.fft.irfft(spectrum * np.conj(spectrum), n)[: max_period * 4 + 1]
    acf = acf / max(acf[0], 1e-9)

    periods = np.arange(min_period, max_period + 1)
    # comb: sum autocorrelation at multiples of the candidate period
    scores = np.zeros(len(periods))
    for i, p in enumerate(periods):
        lags = np.arange(1, 5) * p
        lags = lags[lags < len(acf)]
        scores[i] = acf[lags].mean() if len(lags) else 0.0

    # mild preference for the typical ranked-map BPM octave
    bpm = 60000.0 / (periods * frame_ms)
    pref = np.where((bpm >= PREFERRED_LO) & (bpm <= PREFERRED_HI), 1.05, 1.0)
    scores = scores * pref

    best = scores.max()
    # fastest period within 5% of the best score (fights half-tempo picks)
    good = np.flatnonzero(scores >= 0.95 * best)
    period = float(periods[good[0]])
    beat_len = period * frame_ms

    # octave-shift into the playable range
    while 60000.0 / beat_len > MAX_BPM:
        beat_len *= 2.0
    while 60000.0 / beat_len < MIN_BPM:
        beat_len /= 2.0
    return beat_len


def estimate_tempo(
    onsets: np.ndarray, frame_times: np.ndarray
) -> tuple[float, float]:
    """onset envelope (L,) in [0,1] + frame times (ms) -> (beat_length_ms,
    offset_ms of the first beat)"""
    if len(frame_times) < 8:
        return 500.0, 0.0
    frame_ms = float(frame_times[1] - frame_times[0])
    beat_len = _comb_beat_len(onsets, frame_ms)
    if beat_len is None:
        return 500.0, 0.0

    env = onsets.astype(np.float64)
    env = env - env.mean()
    env = np.maximum(env, 0.0)

    # joint sub-frame refinement of period x phase: an integer-frame period
    # is off by up to half a frame (~3 ms), which drifts by whole beats over
    # a full song; search +-1 frame around each candidate at 1/40-frame
    # resolution, scoring onset mass on the resulting beat grid
    env_total = max(float(env.sum()), 1e-9)

    def _refine_around(p0: float) -> tuple[float, float, float, float]:
        """-> (coverage, mass, period, offset) of the best sub-frame
        period x phase near p0; coverage = fraction of total onset mass the
        grid's ticks capture, mass = mean env at the ticks"""
        best_p, best_offset, best_mass = p0, 0.0, -1.0
        for p in np.linspace(p0 - 1.0, p0 + 1.0, 81):
            if p < 2.0:
                continue
            n_phase = max(16, int(2 * p))
            phases = np.arange(n_phase) * (p / n_phase)
            n_beats = int((len(env) - p) // p)
            if n_beats < 1:
                continue
            idx = (phases[:, None] + np.arange(n_beats + 1)[None, :] * p).astype(int)
            masses = env[np.minimum(idx, len(env) - 1)].mean(axis=1)
            k = int(np.argmax(masses))
            if masses[k] > best_mass:
                best_mass, best_p, best_offset = (
                    float(masses[k]), float(p), float(phases[k])
                )
        if best_mass < 0:
            return -1.0, -1.0, p0, 0.0
        ticks = np.unique(
            (best_offset + np.arange(int((len(env) - 1 - best_offset) // best_p) + 1)
             * best_p).astype(int)
        )
        coverage = float(env[np.minimum(ticks, len(env) - 1)].sum()) / env_total
        return coverage, best_mass, best_p, best_offset

    # the comb's quantization to whole frames can land an octave off (a
    # half-tempo grid scores the same mean mass when every tick still hits
    # an onset): refine all in-range octaves of the pick and choose by
    # onset coverage first (a half-tempo grid captures only half the
    # onsets), then tick mass (a double-tempo grid halves it with empty
    # ticks), then the typical ranked-map band
    p_pick = beat_len / frame_ms
    cands = []
    for mult in (0.5, 1.0, 2.0):
        p0 = p_pick * mult
        bpm0 = 60000.0 / (p0 * frame_ms)
        if not (MIN_BPM - 1e-9 <= bpm0 <= MAX_BPM + 1e-9):
            continue
        cov, mass, p, off = _refine_around(p0)
        if mass < 0:
            continue
        in_band = PREFERRED_LO <= 60000.0 / (p * frame_ms) <= PREFERRED_HI
        cands.append((cov, mass, in_band, p, off))
    if not cands:
        return 500.0, 0.0
    top_cov = max(c[0] for c in cands)
    good = [c for c in cands if c[0] >= 0.95 * top_cov]
    top_mass = max(c[1] for c in good)
    good = [c for c in good if c[1] >= 0.95 * top_mass]
    best = sorted(good, key=lambda c: (not c[2], -c[1]))[0]
    _cov, _mass, _in_band, best_p, best_offset = best

    return best_p * frame_ms, best_offset * frame_ms


def estimate_tempo_segments(
    onsets: np.ndarray,
    frame_times: np.ndarray,
    window_s: float = 20.0,
) -> list[tuple[float, float, float]]:
    """variable-BPM tempo inference -> [(start_ms, beat_length_ms,
    first_beat_offset_ms)], ordered by start; a constant-tempo song yields
    one segment identical to ``estimate_tempo``.

    Method: comb tempo per overlapping window (window_s, hop window_s/2),
    group consecutive windows whose beat lengths agree within ~4%%, then
    re-run the full sub-frame period x phase refinement on each group's
    span. Adjacent groups whose refined beat lengths agree within 1%% are
    re-merged (a transient grouping split, not a tempo change). Songs
    shorter than two windows skip segmentation entirely.
    """
    L = len(frame_times)
    if L < 8 or onsets.max() <= 0:
        return [(0.0, 500.0, 0.0)]
    frame_ms = float(frame_times[1] - frame_times[0])
    win = int(window_s * 1000.0 / frame_ms)
    if L < 2 * win:
        bl, off = estimate_tempo(onsets, frame_times)
        return [(0.0, bl, off)]

    hop = win // 2
    starts = list(range(0, L - win + 1, hop))
    if starts[-1] + win < L:
        starts.append(L - win)

    # per-window comb tempo; silent/short windows inherit their neighbor
    window_bls: list[float | None] = [
        _comb_beat_len(onsets[s : s + win], frame_ms) for s in starts
    ]

    # group consecutive windows with agreeing tempo (octave-normalized:
    # a half/double comb pick within a window is not a tempo change);
    # silent windows (None) carry no tempo evidence and always attach to
    # the adjacent group — leading ones wait for the first real window
    def _same(a: float, b: float) -> bool:
        return octave_ratio_error(a, b) < 0.04

    groups: list[list[int]] = []  # window indices
    pending: list[int] = []  # leading silent windows, no group yet
    anchor: float | None = None
    for i, bl in enumerate(window_bls):
        if bl is None:
            (groups[-1] if groups else pending).append(i)
            continue
        if anchor is not None and _same(bl, anchor):
            groups[-1].append(i)
            continue
        groups.append(pending + [i])
        pending = []
        anchor = bl
    if not groups:
        # every window silent/short: fall back to the whole-song estimate
        bl, off = estimate_tempo(onsets, frame_times)
        return [(0.0, bl, off)]

    def _refine(f0: int, f1: int) -> tuple[float, float]:
        bl, off = estimate_tempo(
            onsets[f0:f1], frame_times[f0:f1] - frame_times[f0]
        )
        return bl, off + float(frame_times[f0])

    # frame span of each group: from its first window's start to the next
    # group's first window's start
    spans: list[tuple[int, int]] = []
    for gi, g in enumerate(groups):
        f0 = starts[g[0]] if gi > 0 else 0
        f1 = starts[groups[gi + 1][0]] if gi + 1 < len(groups) else L
        spans.append((f0, f1))

    # refine each span; merge neighbors whose refined tempo agrees
    segments: list[tuple[int, int, float, float]] = []
    for f0, f1 in spans:
        bl, off = _refine(f0, f1)
        if segments and abs(segments[-1][2] - bl) / bl < 0.01:
            m0 = segments.pop()[0]
            bl, off = _refine(m0, f1)
            segments.append((m0, f1, bl, off))
        else:
            segments.append((f0, f1, bl, off))

    # changepoint search: window grouping places each boundary only to
    # within a window; slide it to the cut that maximizes the onset mass
    # the two grids jointly explain (left grid's ticks before the cut +
    # right grid's ticks after), then re-refine both spans against it
    for i in range(1, len(segments)):
        lf0, _lf1, lbl, loff = segments[i - 1]
        rf0, rf1, rbl, roff = segments[i]
        lo = max(lf0 + hop, rf0 - win)
        hi = min(rf1 - hop, rf0 + win)
        if hi <= lo:
            continue

        def _ticks(bl: float, off: float) -> np.ndarray:
            step = bl / frame_ms
            first = off / frame_ms
            ks = np.arange(
                math.ceil((lo - first) / step), (hi - first) // step + 1
            )
            t = (first + ks * step).astype(int)
            return t[(t >= lo) & (t < hi)]

        lt, rt = _ticks(lbl, loff), _ticks(rbl, roff)
        if len(lt) < 2 or len(rt) < 2:
            continue
        cuts = np.unique(np.concatenate([lt, rt, [lo, hi]]))
        # mass(cut) = env at left ticks < cut + env at right ticks >= cut
        lmass = np.concatenate([[0.0], np.cumsum(onsets[lt])])
        rsum = float(onsets[rt].sum())
        rmass = rsum - np.concatenate([[0.0], np.cumsum(onsets[rt])])
        score = (
            lmass[np.searchsorted(lt, cuts)]
            + rmass[np.searchsorted(rt, cuts)]
        )
        cut = int(cuts[int(np.argmax(score))])
        if cut != rf0:
            segments[i - 1] = (lf0, cut, *_refine(lf0, cut))
            segments[i] = (cut, rf1, *_refine(cut, rf1))

    return [
        (float(frame_times[f0]) if i else 0.0, bl, off)
        for i, (f0, _f1, bl, off) in enumerate(segments)
    ]
