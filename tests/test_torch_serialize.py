"""The port's host tail against the JAX package on the CPU: hit decoding,
tempo inference and the .osu serializer on the same seeded inputs, and the
six fixture beatmaps encoded by the JAX package, decoded by both and parsed
back by both ``Beatmap`` classes.

Tolerance: none. Both sides run the same numpy statements on the same
inputs, with the numpy slider fitter on both (each package's ``native``
pinned off), so hit lists, tempo estimates and .osu texts must be equal, the
texts as strings. The serializer's SV-clamp warnings must match too.
"""

from __future__ import annotations

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.osu"))


@pytest.fixture
def numpy_fitters(monkeypatch):
    """both packages on their numpy paths (fitter, star rating, WAV)"""
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu_torch import native as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _smooth_signal(rng, L: int) -> np.ndarray:
    """a seeded signal in [0, 1] with peaks and plateaus on both sides of
    the 0.5 and 0.7 thresholds"""
    raw = rng.random(L) ** 4
    kernel = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    sig = np.convolve(raw, kernel / kernel.max(), mode="same")
    return np.clip(sig, 0.0, 1.0)


# the edge cases of tests/test_signal_codec.py's extent and hit tests
EDGE_EXTENTS = {
    "starts_high": np.array([1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 0.0]),
    "unterminated": np.array([0.0, 1.0, 1.0, 1.0]),
    "empty": np.zeros(10),
    "one_frame": np.array([0.9]),
}


@pytest.mark.parametrize("case", ["seeded0", "seeded1", "seeded2", *EDGE_EXTENTS])
def test_decode_events_and_extents_match_jax(case):
    from osu_dreamer_tpu.signal import hits as jhits
    from osu_dreamer_tpu_torch.signal import hits as thits

    if case in EDGE_EXTENTS:
        sig = EDGE_EXTENTS[case]
    else:
        sig = _smooth_signal(np.random.default_rng(int(case[-1])), 2000)
    assert thits.decode_events(sig) == jhits.decode_events(sig)
    assert thits.decode_extents(sig) == jhits.decode_extents(sig)
    for name in ("PEAK_HEIGHT", "ONSET_TOL_FRAMES", "MIN_SUSTAIN_FRAMES"):
        assert getattr(thits, name) == getattr(jhits, name)


def _hit_case(case: str) -> np.ndarray:
    """(7, L) hit signals: seeded smooth noise, or the edge cases of
    tests/test_signal_codec.py (flag nearest onset, a slide extent longer
    than twice the sustain, a sustain too short to trust)"""
    from osu_dreamer_tpu.audio import get_frame_times
    from osu_dreamer_tpu.signal.encoding import Channel
    from osu_dreamer_tpu.signal.hits import events_signal, extents_signal

    if case.startswith("seeded"):
        rng = np.random.default_rng(10 + int(case[-1]))
        return np.stack([_smooth_signal(rng, 1500) for _ in range(7)])
    L = 200
    ft = get_frame_times(L)
    sig = np.zeros((7, L))
    if case == "flag_nearest_onset":
        t0, t1 = float(ft[50]), float(ft[52])
        sig[Channel.ONSET] = events_signal([t0, t1], ft)
        sig[Channel.WHISTLE] = events_signal([t0], ft)
    elif case == "long_slide":
        t0 = float(ft[20])
        sig[Channel.ONSET] = events_signal([t0], ft)
        sig[Channel.SUSTAIN] = extents_signal([(t0, float(ft[30]))], ft)
        sig[Channel.SLIDE] = extents_signal([(t0, float(ft[60]))], ft)
    elif case == "short_sustain":
        t0 = float(ft[20])
        sig[Channel.ONSET] = events_signal([t0, float(ft[120])], ft)
        sig[Channel.SUSTAIN] = extents_signal([(t0, float(ft[22])), (float(ft[120]),
                                                                     float(ft[160]))], ft)
    return sig


@pytest.mark.parametrize("case", ["seeded0", "seeded1", "flag_nearest_onset", "long_slide",
                                  "short_sustain"])
def test_decode_hit_signal_matches_jax(case):
    from osu_dreamer_tpu.signal.hits import decode_hit_signal as jdecode
    from osu_dreamer_tpu_torch.signal.hits import decode_hit_signal as tdecode

    sig = _hit_case(case)
    got = tdecode(sig)
    assert got == jdecode(sig)
    assert got, "the case decodes to no hit at all"


def _onset_envelope(seed: int, seconds: float, bpms: tuple[float, ...]) -> tuple:
    """a seeded onset envelope: beats (some skipped, some halved) at each
    tempo for an equal share of the song, with jitter and noise"""
    from osu_dreamer_tpu.audio import get_frame_for_time, get_frame_times
    from osu_dreamer_tpu.signal.hits import events_signal

    rng = np.random.default_rng(seed)
    ft = get_frame_times(get_frame_for_time(seconds * 1000.0))
    ts, t = [], 400.0 + rng.uniform(0, 200)
    for k, bpm in enumerate(bpms):
        end = seconds * 1000.0 * (k + 1) / len(bpms)
        beat = 60000.0 / bpm
        while t < end:
            if rng.random() > 0.15:
                ts.append(t + rng.normal(0, 2.0))
            if rng.random() < 0.3:
                ts.append(t + beat / 2)
            t += beat
    env = events_signal(sorted(ts), ft) + rng.random(len(ft)) * 0.1
    return np.clip(env, 0.0, 1.0), ft


@pytest.mark.parametrize("case", [(0, 30.0, (172.0,)), (1, 12.0, (96.0,)),
                                  (2, 60.0, (150.0, 180.0)), (3, 70.0, (128.0, 128.0, 200.0)),
                                  (4, 1.0, (120.0,))])
def test_tempo_matches_jax(case):
    from osu_dreamer_tpu.signal import tempo as jtempo
    from osu_dreamer_tpu_torch.signal import tempo as ttempo

    env, ft = _onset_envelope(*case)
    assert ttempo.estimate_tempo(env, ft) == jtempo.estimate_tempo(env, ft)
    segments = ttempo.estimate_tempo_segments(env, ft)
    assert segments == jtempo.estimate_tempo_segments(env, ft)
    if case[2] == (150.0, 180.0):
        assert len(segments) == 2, segments
    silent = np.zeros_like(env)
    assert ttempo.estimate_tempo_segments(silent, ft) == jtempo.estimate_tempo_segments(silent, ft)


def _seeded_chart(seed: int, L: int = 4000) -> tuple[np.ndarray, np.ndarray]:
    """a seeded quantized chart: onsets on a 165 BPM grid with a silent gap
    of over 5 s (a break), holds of 1-3 slides and spinners, hit sounds,
    noise, a smooth cursor path -> (hit_u8 (L, 7), xy_i16 (L, 2)) as the
    sampler's transfer format holds them"""
    from osu_dreamer_tpu.audio import get_frame_times
    from osu_dreamer_tpu.signal.encoding import Channel
    from osu_dreamer_tpu.signal.hits import events_signal, extents_signal

    rng = np.random.default_rng(seed)
    ft = get_frame_times(L)
    beat = 60000.0 / 165.0
    grid = np.arange(300.0, ft[-1] - 1500.0, beat / 2)
    grid = grid[(grid < 9000.0) | (grid > 15000.0)]  # the break
    onsets, sustains, slides, flags = [], [], [], {c: [] for c in range(4)}
    busy_until = 0.0
    for t in grid:
        if t < busy_until or rng.random() < 0.35:
            continue
        onsets.append(t)
        for c in range(4):
            if rng.random() < 0.25:
                flags[c].append(t)
        u = rng.random()
        if u < 0.3:  # slider of 1-3 slides
            n = int(rng.integers(1, 4))
            end = t + beat * rng.integers(1, 4)
            sustains.append((t, end))
            slides.append((t, t + (end - t) / n))
            busy_until = end + beat / 2
        elif u < 0.35:  # spinner
            end = t + beat * 4
            sustains.append((t, end))
            busy_until = end + beat / 2
    hit = np.zeros((7, L))
    hit[Channel.ONSET] = events_signal(onsets, ft)
    for c, ch in enumerate((Channel.COMBO, Channel.WHISTLE, Channel.FINISH, Channel.CLAP)):
        hit[ch] = events_signal(flags[c], ft)
    hit[Channel.SUSTAIN] = extents_signal(sustains, ft)
    hit[Channel.SLIDE] = extents_signal(slides, ft)
    hit += rng.normal(0.0, 0.03, hit.shape)
    steps = rng.normal(0.0, 0.004, (L, 2)).cumsum(axis=0)
    kernel = np.hanning(31) / np.hanning(31).sum()
    xy = np.stack([np.convolve(steps[:, i], kernel, mode="same") for i in range(2)], axis=1)
    xy = 0.5 + xy - xy.mean(axis=0)
    hit_u8 = np.round(np.clip(hit.T, 0.0, 1.0) * 255.0).astype(np.uint8)
    xy_i16 = np.round(np.clip(xy, -4.0, 4.0) * 8191.0).astype(np.int16)
    return hit_u8, xy_i16


def _noise_chart(seed: int, L: int = 700) -> tuple[np.ndarray, np.ndarray]:
    """uniform noise in the transfer format: spurious peaks, ragged extents,
    a cursor that jumps, and (against an inferred tempo) sliders whose SV
    leaves [0.1, 10]"""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (L, 7), dtype=np.uint8),
            rng.integers(-6000, 14000, (L, 2), dtype=np.int16))


def _osu_both(signal, labels, infer_tempo, snap_divisor, version=1):
    from osu_dreamer_tpu.signal.serialize import decode_osu_entry as jentry
    from osu_dreamer_tpu_torch.signal.serialize import decode_osu_entry as tentry

    out = []
    for entry in (jentry, tentry):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            name, text = entry("Song", "Artist", "song.wav", version, labels, signal,
                               infer_tempo, snap_divisor)
        out.append((name, text, [str(w.message) for w in caught]))
    return out


MODES = {"plain": (False, 0), "infer_tempo": (True, 0), "snap4": (False, 4)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("chart", ["seeded0", "seeded1", "noise"])
def test_decode_osu_entry_matches_jax(numpy_fitters, chart, mode):
    """the same dequantized chart -> the same .osu name and text, string for
    string, and the same warnings"""
    from osu_dreamer_tpu.models.inference.sampler import dequantize_chart

    hit_u8, xy_i16 = _noise_chart(5) if chart == "noise" else _seeded_chart(int(chart[-1]))
    signal = dequantize_chart(hit_u8, xy_i16).T
    labels = np.array([5.25, 9.0, 8.5, 4.0, 6.0], np.float32)
    (jname, jtext, jwarn), (tname, ttext, twarn) = _osu_both(signal, labels, *MODES[mode])
    assert tname == jname
    assert ttext == jtext
    assert twarn == jwarn
    if chart != "noise":
        assert "\n2," in jtext  # the break
        assert jtext.count("|") > 5  # fitted sliders
    elif mode != "plain":
        assert twarn  # SVs against the inferred tempo left [0.1, 10] and were clamped


def test_serialize_imports_no_torch():
    """the spawn-pool workers import signal/serialize.py: its imports pull in
    neither torch nor the JAX package"""
    code = ("import sys\n"
            "import osu_dreamer_tpu_torch.signal.serialize\n"
            "bad = [m for m in ('torch', 'jax', 'osu_dreamer_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _objects(bm) -> list:
    """a parsed beatmap's hit objects and timing points, as plain values"""
    out = []
    for o in bm.hit_objects:
        row = [type(o).__name__, o.t, o.end_time(), o.new_combo, o.whistle, o.finish, o.clap,
               o.start_pos().tolist(), o.end_pos().tolist()]
        if hasattr(o, "slides"):
            row += [o.slides, o.length, o.slide_duration, np.asarray(o.ctrl_pts).tolist()]
        out.append(row)
    out += [[tp.t, tp.beat_length, tp.slider_mult, tp.meter] for tp in bm.timing_points]
    out += [[b.t, b.u] for b in bm.breaks]
    return out


@pytest.mark.parametrize("fixture", [f.name for f in FIXTURES])
def test_fixture_roundtrip_matches_jax(numpy_fitters, fixture):
    """a fixture beatmap encoded by the JAX package (hit_signal,
    cursor_signal), decoded to .osu text by both packages (the same text),
    then parsed by both Beatmap classes: the same hit objects, timing
    points, breaks and star rating, and the port's parse of its own text
    keeps the fixture's objects"""
    from osu_dreamer_tpu.audio import get_frame_for_time, get_frame_times
    from osu_dreamer_tpu.osu import Beatmap as JBeatmap
    from osu_dreamer_tpu.signal import cursor_signal, get_labels, hit_signal
    from osu_dreamer_tpu_torch.osu import Beatmap as TBeatmap

    src = JBeatmap.from_file(REPO / "tests" / "fixtures" / fixture)
    assert len(FIXTURES) == 6
    end = max(o.end_time() for o in src.hit_objects) + 1000
    ft = get_frame_times(get_frame_for_time(end))
    enc = np.concatenate([hit_signal(src, ft), cursor_signal(src, ft)])
    labels = get_labels(src)
    (jname, jtext, _), (tname, ttext, _) = _osu_both(enc, labels, False, 0)
    assert (tname, ttext) == (jname, jtext)

    tbm, jbm = TBeatmap(ttext), JBeatmap(jtext)
    assert _objects(tbm) == _objects(jbm)
    assert (tbm.title, tbm.artist, tbm.version, tbm.hp, tbm.cs, tbm.od, tbm.ar,
            tbm.slider_mult) == (jbm.title, jbm.artist, jbm.version, jbm.hp, jbm.cs, jbm.od,
                                 jbm.ar, jbm.slider_mult)
    assert tbm.sr == jbm.sr
    assert len(tbm.hit_objects) == len(src.hit_objects)
    # the port parses the fixture itself as the JAX package does
    assert _objects(TBeatmap.from_file(REPO / "tests" / "fixtures" / fixture)) == _objects(src)
