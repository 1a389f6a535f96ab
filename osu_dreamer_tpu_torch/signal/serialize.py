""".osu serializer: decoded hits + cursor path -> a playable beatmap file.

Copy of osu_dreamer_tpu/signal/serialize.py: hit circles, spinners and
MAP-fitted sliders, a break for each gap over 5 s, one global uninherited
timing point with ``beat_len = 100 / sqrt(min_vel * max_vel)`` (or, with
``infer_tempo``, one per inferred tempo segment, and with ``snap_divisor``
hit times snapped to that grid), and one inherited point (``-100/SV``) per
slider, its SV clamped to [0.1, 10] with a warning. The text is the JAX
package's byte for byte.

Its imports stay free of torch: predict's spawn-pool workers import this
module, and a worker that imported torch would pay seconds at start.
"""

from __future__ import annotations

import bisect
import math
import warnings
from dataclasses import dataclass

import numpy as np

from ..audio.constants import get_frame_times
from .constants import NUM_LABELS
from .encoding import Channel, HitChannels
from .fit import fit_slider
from .hits import decode_hit_signal

BREAK_GAP_MS = 5000
PLAYFIELD = np.array([[512.0], [384.0]])


@dataclass
class MapMetadata:
    audio_filename: str
    title: str
    artist: str
    version: str = "osu!dreamer-tpu model"


def decode_osu_entry(
    title: str,
    artist: str,
    audio_name: str,
    version_i: int,
    label_row: np.ndarray,
    signal: np.ndarray,
    infer_tempo: bool = False,
    snap_divisor: int = 0,
) -> tuple[str, str]:
    """one generated difficulty -> (.osu entry name, .osu text). The single
    naming/decode used by BOTH bulk predict and the serve service (top-level
    so it pickles to predict's spawn-pool workers)."""
    name = f"{artist} - {title} (osu!dreamer-tpu) [version {version_i}].osu"
    text = decode_beatmap(
        MapMetadata(audio_name, title, artist, f"version {version_i}"),
        label_row,
        signal,
        infer_tempo=infer_tempo,
        snap_divisor=snap_divisor,
    )
    return name, text


def _hit_sound_bits(whistle: bool, finish: bool, clap: bool) -> int:
    return (whistle << 1) | (finish << 2) | (clap << 3)


def decode_beatmap(
    meta: MapMetadata,
    labels: np.ndarray,
    enc: np.ndarray,
    infer_tempo: bool = False,
    snap_divisor: int = 0,
) -> str:
    """(X_DIM, L) predicted signal + labels -> .osu file contents.

    ``infer_tempo`` estimates the beat period/phase from the onset envelope
    (signal/tempo.py) instead of deriving the tempo from slider velocities —
    capability beyond the reference, which leaves this as a TODO. Tempo
    CHANGES are handled: one uninherited timing point per inferred segment
    (estimate_tempo_segments), and slider SVs are computed against their
    own segment's beat length.

    ``snap_divisor > 0`` additionally snaps hit times onto 1/divisor of the
    inferred beat (4 = sixteenth notes), the editor convention ranked maps
    follow; it implies tempo inference so the grid and the emitted timing
    point agree. Start times stay monotonic (a snap that would land before
    the previous object's end rolls forward to the next tick), and
    slider/spinner ends stay strictly after their starts."""
    assert enc.ndim == 2 and enc.shape[0] == len(Channel), (
        f"enc must be ({len(Channel)}, L), got {enc.shape}"
    )
    assert labels.shape[-1] == NUM_LABELS
    snap_divisor = int(snap_divisor)
    infer_tempo = bool(infer_tempo) or snap_divisor > 0
    if infer_tempo:
        from .tempo import estimate_tempo_segments

        # [(start_ms, beat_len_ms, first_beat_offset_ms)], >= 1 segment;
        # offsets quantized to whole ms HERE so the snap grid and the
        # emitted `{off:.0f}` timing point are anchored identically
        segments = [
            (s, bl, float(round(off)))
            for s, bl, off in estimate_tempo_segments(
                enc[Channel.ONSET], get_frame_times(enc.shape[1])
            )
        ]
        # governance switches at the EMITTED timing point (off), matching
        # the osu! editor: a tick of segment i never predates its TP line
        seg_offs = [off for _s, _bl, off in segments]

        def _seg_i(t: float) -> int:
            return max(bisect.bisect_right(seg_offs, t) - 1, 0)

        def _seg(t: float) -> tuple[float, float, float]:
            return segments[_seg_i(t)]

    if snap_divisor > 0:

        def snap(t: float, floor: int | None = None) -> int:
            # nearest tick of the governing segment's grid; `floor` rolls an
            # early landing forward to the first tick at/after it. If the
            # result crosses into a later segment, re-snap on THAT grid —
            # the emitted time must sit on the grid of the timing point
            # that governs it
            tq = float(t)
            for _ in range(len(segments) + 1):
                i = _seg_i(tq)
                _s, bl, off = segments[i]
                tick = bl / snap_divisor
                k = round((tq - off) / tick)
                if floor is not None:
                    k = max(k, math.ceil((floor - off) / tick - 1e-9))
                s_ms = off + k * tick
                if _seg_i(s_ms) == i:
                    return int(round(s_ms))
                tq = s_ms  # landed past the next timing point: re-resolve
            return int(round(tq))
    else:

        def snap(t: float, floor: int | None = None) -> int:
            return int(t)

    frame_ms = get_frame_times(enc.shape[1]).round().astype(int)
    cursor = enc[[Channel.X, Channel.Y]] * PLAYFIELD

    # sliders render AFTER the tempo is known: the emitted pixel length must
    # agree with the (clamped) SV so the parsed end time equals end_t
    hit_lines: list[str | dict] = []
    break_lines: list[str] = []
    slider_vels: list[float] = []
    prev_end: int | None = None
    prev_t = -(10**9)
    first_hit_t: int | None = None

    for hit in decode_hit_signal(enc[HitChannels]):
        onset_frame, new_combo, whistle, finish, clap, *hold = hit
        # starts may touch the previous object's END (legal .osu) but never
        # its START — two onsets snapping onto one tick would stack
        floor = None if prev_end is None else max(prev_end, prev_t + 1)
        t = snap(int(frame_ms[onset_frame]), floor=floor)
        prev_t = t
        if first_hit_t is None:
            first_hit_t = t
        combo_bit = 1 << 2 if new_combo else 0
        sound = _hit_sound_bits(whistle, finish, clap)

        if prev_end is not None and t - prev_end > BREAK_GAP_MS:
            break_lines.append(f"2,{prev_end},{t}")

        def emit_circle():
            x, y = cursor[:, onset_frame].round().astype(int)
            hit_lines.append(f"{x},{y},{t},{(1 << 0) + combo_bit},{sound},0:0:0:0:")

        if not hold:
            emit_circle()
            prev_end = t
            continue

        end_frame, num_slides = hold
        end_t = snap(int(frame_ms[end_frame]), floor=t + 1)

        if num_slides == 0:  # spinner
            hit_lines.append(f"256,192,{t},{(1 << 3) + combo_bit},{sound},{end_t}")
            prev_end = end_t
            continue

        curve_type, length, ctrl_pts = fit_slider(cursor, onset_frame, end_frame, num_slides)
        if length == 0:
            emit_circle()
            prev_end = t
            continue

        head = ctrl_pts[0]
        path = "|".join(f"{x}:{y}" for x, y in ctrl_pts[1:])
        hit_lines.append({
            "prefix": f"{head[0]},{head[1]},{t},{(1 << 1) + combo_bit},{sound},"
                      f"{curve_type}|{path},{num_slides},",
            "t": t, "end_t": end_t, "slides": num_slides, "length": length,
        })
        prev_end = end_t
        slider_vels.append(length * num_slides / (end_t - t))

    if infer_tempo:
        # the first uninherited point must not postdate the first object:
        # parsers drop inherited (slider SV) lines that precede every
        # uninherited line, and objects before the first timing point fall
        # back to SV 1. Shifting back by whole beats preserves the grid.
        s0, bl0, off0 = segments[0]
        if first_hit_t is not None and first_hit_t < off0:
            segments[0] = (s0, bl0, off0 - math.ceil((off0 - first_hit_t) / bl0) * bl0)
            seg_offs = [off for _s, _bl, off in segments]

        uninherited = [
            (off, 0, f"{off:.0f},{bl},4,0,0,50,1,0") for _s, bl, off in segments
        ]

        def beat_len_at(t: float) -> float:
            return _seg(t)[1]
    else:
        # one global tempo chosen so slider SVs cluster around 1:
        # slide time = length / (slider_mult * 100 * SV) * beat_len with
        # slider_mult = 1 => SV = vel * beat_len / 100; pick beat_len so the
        # geometric mid of observed velocities maps to SV = 1
        if slider_vels:
            base_vel = float(np.sqrt(min(slider_vels) * max(slider_vels)))
        else:
            base_vel = 1.0
        beat_len = 100.0 / base_vel
        uninherited = [(0.0, 0, f"0,{beat_len},4,0,0,50,1,0")]

        def beat_len_at(t: float) -> float:
            return beat_len

    # render sliders: SV clamped to the format's [0.1, 10] and rounded UP to
    # the parser's 3-decimal grid (both keep the parsed duration <= the
    # intended end_t - t, preserving object monotonicity); the emitted pixel
    # length is recomputed against the final SV so the end time is exact
    inherited = []
    rendered: list[str] = []
    for entry in hit_lines:
        if isinstance(entry, str):
            rendered.append(entry)
            continue
        t, end_t, slides = entry["t"], entry["end_t"], entry["slides"]
        bl = beat_len_at(t)
        sv = entry["length"] * slides / (end_t - t) * bl / 100.0
        if not 0.1 <= sv <= 10.0:
            warnings.warn(
                f"slider SV {sv:.3f} outside [0.1, 10]; clamping and "
                "rescaling the played length to keep the end time"
            )
        sv = math.ceil(min(max(sv, 0.1), 10.0) * 1000.0) / 1000.0
        length = sv * 100.0 / bl * (end_t - t) / slides
        rendered.append(entry["prefix"] + f"{length}")
        inherited.append((float(t), 1, f"{t},{-100.0 / sv},4,0,0,50,0,0"))
    hit_lines = rendered

    # the parser is a sequential state machine: lines must be time-sorted,
    # uninherited first on ties (an inherited line needs a governing tempo)
    timing_lines = [line for _t, _k, line in sorted(uninherited + inherited)]

    sections = f"""osu file format v14

[General]
AudioFilename: {meta.audio_filename}
AudioLeadIn: 0
Mode: 0

[Metadata]
Title: {meta.title}
TitleUnicode: {meta.title}
Artist: {meta.artist}
ArtistUnicode: {meta.artist}
Creator: osu!dreamer-tpu
Version: {meta.version}
Tags: osu_dreamer_tpu

[Difficulty]
HPDrainRate: {labels[4]}
CircleSize: {labels[3]}
OverallDifficulty: {labels[2]}
ApproachRate: {labels[1]}
SliderMultiplier: 1
SliderTickRate: 1

[Events]
{chr(10).join(break_lines)}

[TimingPoints]
{chr(10).join(timing_lines)}

[HitObjects]
{chr(10).join(hit_lines)}
"""
    return sections
