"""Seeded synthetic data for driving training without real data:

- ``make_mapset``, ``build_library`` and ``write_wav``: a copy of
  osu_dreamer_tpu/data/synth.py (tests/test_torch_ingest.py pins it to the
  original: the same generator draws give the same .osu texts and wave).
  Mapsets whose audio is correlated with the chart, a percussive click at
  every hit time over a tonal bed, written as extracted folders with a
  16-bit mono WAV at SR, for ``generate-data --songs-dir``;
- ``write_signal_corpus``: laid out as ``generate-data`` writes it (per
  mapset directory a uint8 ``spec.npy`` (A_DIM, L), per map a ``<id>.map.npy``
  in ``write_beatmap``'s npz format), for ``fit-latent`` and
  ``encode-latents``;
- ``write_latent_corpus``: laid out as ``encode-latents`` writes it (per
  mapset ``h.npy`` (l, A), per map ``<id>.latent.npz`` with ``z`` (l, E),
  ``s`` (S,) and ``labels`` (5,)), for ``fit-denoiser`` without a trained
  latent stage.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..audio.constants import A_DIM, SR
from ..signal.constants import HIT_DIM, NUM_LABELS
from ..signal.encoding import HIT_DTYPE, XY_DTYPE


def write_signal_corpus(root: str | Path, n_mapsets: int, maps_per_set: int, length: int,
                        seed: int = 0) -> Path:
    """-> ``root``. A mapset's spectrogram is uniform noise; a map's hit
    channels are sparse full-strength pulses, its cursor a random walk in the
    unit square, quantized as ``write_beatmap`` quantizes it, its labels
    uniform in [0, 10]"""
    rng = np.random.default_rng(seed)
    root = Path(root)
    for m in range(n_mapsets):
        d = root / f"set{m:04d}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "spec.npy", rng.integers(0, 256, (A_DIM, length), dtype=np.uint8))
        for i in range(maps_per_set):
            hit = (rng.random((HIT_DIM, length)) < 0.05) * np.iinfo(HIT_DTYPE).max
            xy = np.clip(0.5 + np.cumsum(rng.normal(0, 0.01, (2, length)), axis=1), 0, 1)
            xy_min = xy.min(axis=1, keepdims=True)
            xy_rng = xy.max(axis=1, keepdims=True) - xy_min
            xy_rng[xy_rng == 0.0] = 1.0
            # through a file handle: np.savez given a path would append .npz
            with open(d / f"{i}.map.npy", "wb") as f:
                np.savez(
                    f, allow_pickle=False,
                    hit=hit.astype(HIT_DTYPE),
                    xy=np.round((xy - xy_min) / xy_rng * np.iinfo(XY_DTYPE).max).astype(XY_DTYPE),
                    xy_min=xy_min, xy_rng=xy_rng,
                    labels=rng.uniform(0, 10, NUM_LABELS),
                )
    return root


def write_latent_corpus(root: str | Path, n_mapsets: int, maps_per_set: int, length: int,
                        a_dim: int, emb_dim: int, style_dim: int, seed: int = 0) -> Path:
    """-> ``root``; every array is f32 drawn from ``seed``"""
    rng = np.random.default_rng(seed)
    root = Path(root)
    for m in range(n_mapsets):
        d = root / f"set{m:04d}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "h.npy", rng.random((length, a_dim), dtype=np.float32))
        for i in range(maps_per_set):
            z = rng.standard_normal((length, emb_dim), dtype=np.float32)
            z /= np.sqrt((z * z).mean(-1, keepdims=True))  # per-frame RMS 1, as the latents
            np.savez(d / f"{i}.latent.npz", z=z,
                     s=rng.standard_normal(style_dim, dtype=np.float32),
                     labels=rng.uniform(0, 10, NUM_LABELS).astype(np.float32))
    return root


# difficulties per generated mapset (consumers sizing batches per map count
# should use this rather than re-deriving it)
DIFFS_PER_MAPSET = 3


def _osu_text(
    objs: list[str],
    *,
    title: str,
    version: str,
    audio_name: str,
    timing: list[tuple[float, float]],  # (offset_ms, bpm) per tempo section
    ar: float,
    cs: float,
    od: float,
    hp: float,
    slider_mult: float,
) -> str:
    tp_lines = "\n".join(
        f"{off:.0f},{60_000.0 / bpm},4,2,0,60,1,0" for off, bpm in timing
    )
    return (
        "osu file format v14\n\n"
        f"[General]\nAudioFilename: {audio_name}\nMode: 0\n\n"
        f"[Metadata]\nTitle: {title}\nArtist: synth\nCreator: synth\n"
        f"Version: {version}\n\n"
        f"[Difficulty]\nHPDrainRate: {hp}\nCircleSize: {cs}\n"
        f"OverallDifficulty: {od}\nApproachRate: {ar}\n"
        f"SliderMultiplier: {slider_mult}\nSliderTickRate: 1\n\n"
        f"[TimingPoints]\n{tp_lines}\n\n"
        "[HitObjects]\n" + "\n".join(objs) + "\n"
    )


def make_mapset(
    rng: np.random.Generator,
    seconds: float = 60.0,
    n_difficulties: int = DIFFS_PER_MAPSET,
    tempo_change: bool = False,
) -> tuple[list[str], np.ndarray, np.ndarray]:
    """-> (.osu texts, mono wave at SR, onset times in ms of the densest
    difficulty). The densest difficulty (d0) realizes the rhythm grid; the
    others place objects only at a SUBSET of d0's onsets (thinned, subject
    to their own slider/spinner occupancy) and use easier difficulty
    settings — the same structure as a real mapset, and it guarantees every
    chart's hit times have a click in the shared audio.

    ``tempo_change`` makes the song VARIABLE-BPM: a second tempo section
    (non-octave ratio of the first) starts 40-60% in, with its own
    uninherited timing point — for exercising segmented tempo inference
    end-to-end."""
    bpm = float(rng.uniform(120, 200))
    offset = float(rng.uniform(400, 900))
    end_ms = seconds * 1000.0 - 2000.0

    # tempo sections: [(start_ms, first_beat_ms, bpm)]
    if tempo_change:
        ratio = float(rng.choice([0.75, 0.8, 1.25, 4.0 / 3.0]))
        bpm2 = float(np.clip(bpm * ratio, 100.0, 240.0))
        change = end_ms * float(rng.uniform(0.4, 0.6))
        sections = [(offset, offset, bpm), (change, change, bpm2)]
    else:
        sections = [(offset, offset, bpm)]

    # rhythm grid with music-like density structure (VERDICT r2 item 6):
    # a per-song base density, measure-level modulation (sparse "verse"
    # measures vs dense "kiai" measures), and occasional 1/4-note stream
    # measures — instead of a single iid coin per beat
    base_p = float(rng.uniform(0.65, 0.9))
    half_p = float(rng.uniform(0.15, 0.4))
    grid: list[float] = []
    for si, (start, first_beat, sec_bpm) in enumerate(sections):
        sec_end = sections[si + 1][0] if si + 1 < len(sections) else end_ms
        sec_beat = 60_000.0 / sec_bpm
        t = first_beat
        beat_i = 0
        measure_gain = 1.0
        stream_measure = False
        while t < sec_end:
            if beat_i % 4 == 0:  # new measure: redraw its density character
                u = rng.random()
                measure_gain = 0.45 if u < 0.2 else (1.25 if u < 0.45 else 1.0)
                stream_measure = rng.random() < 0.12
            if rng.random() < min(base_p * measure_gain, 0.97):
                grid.append(t)
            if stream_measure:
                # 1/4 stream: fill every quarter of this beat
                for q in (0.25, 0.5, 0.75):
                    if t + sec_beat * q < sec_end:
                        grid.append(t + sec_beat * q)
            elif rng.random() < half_p * measure_gain and t + sec_beat / 2 < sec_end:
                grid.append(t + sec_beat / 2)
            t += sec_beat
            beat_i += 1
    grid.sort()

    def beat_len_at(tq: float) -> float:
        sec = max(
            (s for s in sections if s[0] <= tq), key=lambda s: s[0],
            default=sections[0],
        )
        return 60_000.0 / sec[2]

    texts = []
    all_onsets: list[float] = []
    for d in range(n_difficulties):
        keep = 1.0 if d == 0 else rng.uniform(0.5, 0.75)
        # non-densest difficulties draw from d0's EMITTED onsets, not the raw
        # grid — slots d0 dropped (e.g. during its spinners) carry no click
        # in the audio, and objects there would teach onsets without audio
        # evidence
        candidates = grid if d == 0 else list(all_onsets)
        objs: list[str] = []
        pos = rng.uniform([100, 100], [400, 280])
        t_free = 0.0  # next time the track is free (no overlapping objects)
        onsets: list[float] = []
        combo = 0
        for tg in candidates:
            if tg < t_free or (d > 0 and rng.random() > keep):
                continue
            step = rng.uniform(40, 140)
            ang = rng.uniform(0, 2 * np.pi)
            pos = np.clip(
                pos + step * np.array([np.cos(ang), np.sin(ang)]),
                [30, 30], [482, 354],
            )
            x, y = int(pos[0]), int(pos[1])
            new_combo = 4 if combo % 8 == 0 else 0
            combo += 1
            beat_len = beat_len_at(tg)
            # hitsound pattern, not iid noise: claps on offbeats (ranked-map
            # convention), occasional finish at combo starts, some whistles
            hs = 8 if combo % 2 == 0 else (4 if new_combo and rng.random() < 0.5
                                           else (2 if rng.random() < 0.15 else 0))
            r = rng.random()
            if r < 0.65:  # circle
                objs.append(f"{x},{y},{tg:.0f},{1 + new_combo},{hs},0:0:0:0:")
                t_free = tg + 1.0
                onsets.append(tg)
            elif r < 0.92:  # slider: varied shape (L/P/B), span and repeats
                beats = float(rng.choice([0.5, 1.0, 1.0, 1.5, 2.0]))
                length = beats * 140.0  # px at mult 1.4 -> `beats` beats long
                slides = 2 if rng.random() < 0.15 else 1
                ang2 = rng.uniform(0, 2 * np.pi)
                ex = int(np.clip(x + length * np.cos(ang2), 20, 490))
                ey = int(np.clip(y + 0.6 * length * np.sin(ang2), 20, 370))
                shape = rng.random()
                if shape < 0.45:  # straight
                    curve = f"L|{ex}:{ey}"
                elif shape < 0.8:  # circular arc through a bowed midpoint
                    mx = (x + ex) / 2 - (ey - y) * 0.3
                    my = (y + ey) / 2 + (ex - x) * 0.3
                    curve = f"P|{int(np.clip(mx, 10, 500))}:{int(np.clip(my, 10, 374))}|{ex}:{ey}"
                else:  # bezier with one interior control point
                    cx = int(np.clip(x + rng.integers(-80, 80), 10, 500))
                    cy = int(np.clip(y + rng.integers(-80, 80), 10, 374))
                    curve = f"B|{cx}:{cy}|{ex}:{ey}"
                objs.append(
                    f"{x},{y},{tg:.0f},{2 + new_combo},{hs},{curve},{slides},{length:.0f}"
                )
                # slide duration at mult 1.4: length/140*beat_len per slide
                t_free = tg + slides * length / 140.0 * beat_len + 1.0
                pos = np.array([ex, ey], float) if slides % 2 == 1 else np.array([x, y], float)
                onsets.append(tg)
            else:  # spinner over ~2 beats
                t_end = tg + 2 * beat_len
                objs.append(f"256,192,{tg:.0f},{8 + new_combo},{hs},{t_end:.0f}")
                t_free = t_end + beat_len / 2
                onsets.append(tg)
        if d == 0:
            all_onsets = onsets
        texts.append(
            _osu_text(
                objs,
                title=f"synth{rng.integers(1 << 30)}",
                version=f"v{d}",
                audio_name="audio.wav",
                timing=[(first_beat, sec_bpm) for _s, first_beat, sec_bpm in sections],
                # continuous label spread (VERDICT r4 item 4): the r4 corpus
                # pinned cs/hp and made ar/od deterministic in the diff
                # index — a two-point label manifold the style prior could
                # only learn mushily (holdout ar_err 0.875 requesting an
                # in-distribution ar). Jittered ar/od + random cs/hp give the
                # prior a real continuous conditional to learn.
                ar=float(np.clip(9.5 - 1.2 * d + rng.uniform(-1.2, 1.2), 2, 10)),
                cs=float(rng.uniform(2.5, 5.5)),
                od=float(np.clip(8.0 - d + rng.uniform(-1.2, 1.2), 1, 10)),
                hp=float(rng.uniform(3.0, 7.0)),
                slider_mult=1.4,
            )
        )

    wave = _render_audio(rng, seconds, sections, np.asarray(all_onsets))
    return texts, wave, np.asarray(all_onsets)


def _render_audio(
    rng: np.random.Generator,
    seconds: float,
    sections: list[tuple[float, float, float]],  # (start, first_beat, bpm)
    onsets_ms: np.ndarray,
) -> np.ndarray:
    """percussive click at every onset + bass thump per measure + a slowly
    evolving chord bed + noise floor: enough spectral structure that the
    resonator featurizer sees clear onset energy against a moving background"""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    root = float(rng.uniform(110, 220))
    chord = sum(
        a * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28))
        for f, a in (
            (root, 0.10),
            (root * 1.5, 0.06),
            (root * 2.0, 0.05),
            (root * 2.5, 0.04),
        )
    ) * (0.7 + 0.3 * np.sin(2 * np.pi * 0.1 * t))
    wave = chord + 0.005 * rng.normal(size=n)

    # percussive hit: a broadband noise burst (excites every resonator bin)
    # plus a tonal snap. Short (~10 ms decay): 1/4-note streams at 180+ BPM
    # space onsets ~80 ms apart, and longer clicks tile into a continuous
    # wash that erases the onset/background contrast the featurizer (and
    # the model) needs
    click_len = int(0.04 * SR)
    env = np.exp(-np.arange(click_len) / (0.01 * SR))
    click = env * (
        0.7 * rng.normal(size=click_len)
        + 0.5 * np.sin(2 * np.pi * 2400.0 * np.arange(click_len) / SR)
    )
    for ms in onsets_ms:
        i = int(ms / 1000.0 * SR)
        if 0 <= i < n - click_len:
            wave[i : i + click_len] += 0.8 * click

    thump_len = int(0.08 * SR)
    thump = np.exp(-np.arange(thump_len) / (0.02 * SR)) * np.sin(
        2 * np.pi * 60.0 * np.arange(thump_len) / SR
    )
    for si, (_start, first_beat, bpm) in enumerate(sections):
        sec_end_s = (
            sections[si + 1][0] / 1000.0 if si + 1 < len(sections)
            else seconds - 0.1
        )
        beat_len_s = 60.0 / bpm
        tm = first_beat / 1000.0
        while tm < sec_end_s:
            i = int(tm * SR)
            if i < n - thump_len:
                wave[i : i + thump_len] += 0.4 * thump
            tm += 4 * beat_len_s

    peak = np.abs(wave).max()
    return (wave / max(peak, 1e-6) * 0.8).astype(np.float32)


def write_wav(path: Path, wave: np.ndarray) -> None:
    payload = (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, SR, SR * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


def build_library(
    songs_dir: Path, n_mapsets: int, seconds: float = 60.0, seed: int = 0
) -> dict[str, np.ndarray]:
    """write ``n_mapsets`` extracted-folder mapsets under ``songs_dir``
    (consumable by ``generate-data --songs-dir``); returns {mapset dir name:
    onset times ms} for evaluation"""
    rng = np.random.default_rng(seed)
    songs_dir.mkdir(parents=True, exist_ok=True)
    onsets = {}
    for i in range(n_mapsets):
        d = songs_dir / f"{i:03d} synth"
        d.mkdir(exist_ok=True)
        # a quarter of the corpus is variable-BPM so segmented tempo
        # inference and the timing channel see real tempo changes in
        # TRAINING, not only in the holdout eval
        texts, wave, ons = make_mapset(
            rng, seconds=seconds, tempo_change=(i % 4 == 3)
        )
        write_wav(d / "audio.wav", wave)
        for j, text in enumerate(texts):
            (d / f"map{i}_{j}.osu").write_text(text)
        onsets[d.name] = ons
    return onsets
