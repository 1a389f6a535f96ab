""".osu beatmap file parser.

Copy of osu_dreamer_tpu/osu/beatmap.py: section splitting, difficulty
attributes and the star rating (``osu.difficulty``), break events, timing
points with the inherited-point slider-velocity rules, hit objects with the
monotonicity check, and ``timing_point_at`` by bisection.
"""

from __future__ import annotations

import bisect
import math
from functools import cached_property
from pathlib import Path

import numpy as np

from .errors import BeatmapParseError
from .events import Break, Circle, HitObject, Slider, Spinner, Timed, TimingPoint
from .paths import slider_from_control_points

# sections whose lines are lists rather than key:value pairs
_LIST_SECTIONS = frozenset({"Events", "TimingPoints", "HitObjects"})

# hit-object type bits ([HitObjects] column 3)
_CIRCLE_BIT = 1 << 0
_SLIDER_BIT = 1 << 1
_NEW_COMBO_BIT = 1 << 2
_SPINNER_BIT = 1 << 3


def split_sections(text: str) -> dict[str, dict[str, str] | list[str]]:
    """split .osu text into sections; list sections keep raw lines, the rest
    become key->value dicts"""
    sections: dict[str, dict[str, str] | list[str]] = {}
    current: str | None = None
    for raw in text.split("\n"):
        line = raw.strip()
        if raw.startswith("//"):
            continue
        if line == "":
            current = None
            continue
        if line.startswith("[") and line.endswith("]"):
            current = line[1:-1]
            sections[current] = [] if current in _LIST_SECTIONS else {}
            continue
        if current is None:
            continue
        body = sections[current]
        if isinstance(body, list):
            body.append(line)
        else:
            key, sep, value = raw.partition(":")
            if sep:
                body[key.strip()] = value.strip()
    return sections


def _kv(sections: dict, name: str) -> dict[str, str]:
    body = sections.get(name, {})
    return body if isinstance(body, dict) else {}


class Beatmap:
    """a parsed osu!standard beatmap"""

    @classmethod
    def from_file(cls, filename: str | Path) -> "Beatmap":
        with open(filename, encoding="utf-8") as f:
            return cls(f.read())

    def __init__(self, contents: str):
        sections = split_sections(contents)

        general = _kv(sections, "General")
        metadata = _kv(sections, "Metadata")
        difficulty = _kv(sections, "Difficulty")
        editor = _kv(sections, "Editor")

        self.mode = int(general.get("Mode", 0))
        self.title = metadata.get("Title", "")
        self.artist = metadata.get("Artist", "")
        self.creator = metadata.get("Creator", "")
        self.version = metadata.get("Version", "")

        def diff_attr(key: str, default: float) -> float:
            try:
                return float(difficulty[key])
            except (KeyError, ValueError):
                return default

        self.hp = diff_attr("HPDrainRate", 5.0)
        self.cs = diff_attr("CircleSize", 5.0)
        self.od = diff_attr("OverallDifficulty", 5.0)
        # legacy maps omit AR; the osu! client falls back to OD
        self.ar = diff_attr("ApproachRate", self.od)
        self.slider_mult = diff_attr("SliderMultiplier", 1.4)
        self.slider_tick = diff_attr("SliderTickRate", 1.0)

        try:
            self.beat_divisor = int(editor.get("BeatDivisor", 4))
        except ValueError:
            self.beat_divisor = 4

        events = sections.get("Events", [])
        self.breaks = _parse_breaks(events if isinstance(events, list) else [])

        tp_lines = sections.get("TimingPoints")
        if not isinstance(tp_lines, list):
            raise BeatmapParseError("no timing points")
        self.timing_points = _parse_timing_points(tp_lines)

        ho_lines = sections.get("HitObjects")
        if not isinstance(ho_lines, list):
            raise BeatmapParseError("no hit objects")
        self.hit_objects = self._parse_hit_objects(ho_lines)

    def __repr__(self) -> str:
        return f"{self.title} [{self.version}]"

    @cached_property
    def sr(self) -> float:
        """star rating (first-party difficulty calculator; the reference uses
        the rosu-pp Rust crate at beatmap.py:67-75)"""
        from .difficulty import star_rating

        return star_rating(self)

    def timing_point_at(self, t: float) -> TimingPoint | None:
        """the timing point governing time `t`, or None if `t` precedes all"""
        i = bisect.bisect(self.timing_points, Timed(int(t))) - 1
        return self.timing_points[i] if i >= 0 else None

    def uninherited_timing_points(self) -> list[TimingPoint]:
        """timing points deduplicated on (beat_length, meter) only"""
        out: list[TimingPoint] = []
        for tp in self.timing_points:
            canon = TimingPoint(tp.t, tp.beat_length, -1.0, tp.meter)
            if not out or not out[-1].same_effect(canon):
                out.append(canon)
        return out

    def _parse_hit_objects(self, lines: list[str]) -> list[HitObject]:
        objs: list[HitObject] = []
        for line in lines:
            cols = line.split(",")
            x, y, t, type_bits, hit_sound = (int(float(c)) for c in cols[:5])
            new_combo = bool(type_bits & _NEW_COMBO_BIT)

            if type_bits & _CIRCLE_BIT:
                obj: HitObject = Circle(t, new_combo, hit_sound, x, y)
            elif type_bits & _SLIDER_BIT:
                obj = self._parse_slider(cols, t, new_combo, hit_sound, x, y)
            elif type_bits & _SPINNER_BIT:
                obj = Spinner(t, new_combo, hit_sound, int(float(cols[5])))
            else:
                raise BeatmapParseError(f"invalid hit object type: {type_bits}")

            if objs and obj.t < objs[-1].end_time():
                raise BeatmapParseError(
                    f"hit object starts before previous hit object ends: {t}"
                )
            objs.append(obj)

        if not objs:
            raise BeatmapParseError("no hit objects")
        return objs

    def _parse_slider(
        self, cols: list[str], t: int, new_combo: bool, hit_sound: int, x: int, y: int
    ) -> Slider:
        curve_spec, slides, length = cols[5:8]
        _curve_type, *point_specs = curve_spec.split("|")
        ctrl_pts = [np.array([x, y], dtype=float)] + [
            np.array([float(v) for v in spec.split(":")], dtype=float)
            for spec in point_specs
        ]

        tp = self.timing_point_at(t)
        if tp is None:
            tp = self.timing_points[0]
            beat_length, slider_mult = tp.beat_length, 1.0
        else:
            beat_length, slider_mult = tp.beat_length, tp.slider_mult

        return slider_from_control_points(
            t,
            beat_length,
            self.slider_mult * slider_mult,
            new_combo,
            hit_sound,
            int(slides),
            float(length),
            ctrl_pts,
        )


def _parse_breaks(lines: list[str]) -> list[Break]:
    breaks: list[Break] = []
    for line in lines:
        event_type, *params = line.split(",")
        if event_type in ("2", "Break"):
            t, u = params[0], params[1]
            breaks.append(Break(int(float(t)), int(float(u))))
    return breaks


def _parse_timing_points(lines: list[str]) -> list[TimingPoint]:
    points: list[TimingPoint] = []
    beat_length: float | None = None
    slider_mult = 1.0
    meter: int | None = None

    for line in lines:
        vals = [float(v) for v in line.split(",")]
        t, x = vals[0], vals[1]
        row_meter = vals[2] if len(vals) >= 3 else 4.0

        if math.isnan(x):
            raise BeatmapParseError("nan timing point")

        if x < 0:
            # inherited point: adjusts the slider velocity only
            if not points:
                continue
            if points[-1].t == t:
                # replaces a point at the same timestamp
                points.pop()
            slider_mult = min(10.0, max(0.1, round(-100.0 / x, 3)))
        else:
            # uninherited point: sets tempo + meter, resets slider velocity
            beat_length = x
            slider_mult = 1.0
            meter = int(row_meter)

        if beat_length is None or meter is None:
            raise BeatmapParseError(
                "inherited timing point appears before any uninherited timing points"
            )

        tp = TimingPoint(int(t), beat_length, slider_mult, meter)
        if not points or not tp.same_effect(points[-1]):
            points.append(tp)

    if not points:
        raise BeatmapParseError("no timing points")
    return points
