"""osu!standard star rating: the classic two-skill (aim, speed) strain model.

Copy of osu_dreamer_tpu/osu/difficulty.py: spacing-weighted strain
increments, exponential decay (aim 0.15, speed 0.3 per second), 400 ms
sections summed with weights 0.9^k, sqrt(difficulty) * 0.0675 stars per
skill, total = aim + speed + 0.5 |aim - speed|. ``star_rating`` takes the C++
implementation (native/osudreamer_native.cpp, through the port's ``native``
binding) when it is loaded, else the numpy one with the same semantics.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from .beatmap import Beatmap

# strain model constants (legacy osu!std difficulty calculator)
_DECAY_BASE = (0.3, 0.15)  # (speed, aim) strain decay per second
_WEIGHT_SCALING = (1400.0, 26.25)  # (speed, aim) skill balance
_STAR_SCALE = 0.0675
_EXTREME_SCALE = 0.5
_SECTION_MS = 400.0
_DECAY_WEIGHT = 0.9
_NORMALIZED_RADIUS = 52.0
_MIN_DELTA_MS = 50.0

_SINGLE_SPACING = 125.0
_STREAM_SPACING = 110.0
_ALMOST_DIAMETER = 90.0

SPEED, AIM = 0, 1


def _circle_radius(cs: float) -> float:
    """hit-circle radius in osu!pixels for a given circle size"""
    return 32.0 * (1.0 - 0.7 * (cs - 5.0) / 5.0)


def _speed_spacing_weight(distance: float) -> float:
    """spacing multiplier for the speed skill (piecewise in normalized px)"""
    if distance > _SINGLE_SPACING:
        return 2.5
    if distance > _STREAM_SPACING:
        return 1.6 + 0.9 * (distance - _STREAM_SPACING) / (_SINGLE_SPACING - _STREAM_SPACING)
    if distance > _ALMOST_DIAMETER:
        return 1.2 + 0.4 * (distance - _ALMOST_DIAMETER) / (_STREAM_SPACING - _ALMOST_DIAMETER)
    if distance > _ALMOST_DIAMETER / 2.0:
        return 0.95 + 0.25 * (distance - _ALMOST_DIAMETER / 2.0) / (_ALMOST_DIAMETER / 2.0)
    return 0.95


def _aim_spacing_weight(distance: float) -> float:
    return distance**0.99


def _skill_difficulty(times: np.ndarray, strains: np.ndarray, decay: float) -> float:
    """difficulty of one skill: sectioned strain peaks, geometric sum"""
    if len(times) == 0:
        return 0.0

    peaks: list[float] = []
    section_end = _SECTION_MS * np.ceil(max(times[0], 1.0) / _SECTION_MS)
    current = 0.0
    running = 0.0  # strain carried between objects

    for i in range(len(times)):
        t = times[i]
        while t > section_end:
            peaks.append(current)
            # strain at the start of the next section: decayed from last object
            current = running * decay ** ((section_end - times[max(i - 1, 0)]) / 1000.0)
            section_end += _SECTION_MS
        running = strains[i]
        current = max(current, running)
    peaks.append(current)

    peaks_arr = np.sort(np.asarray(peaks))[::-1]
    weights = _DECAY_WEIGHT ** np.arange(len(peaks_arr))
    return float(np.dot(peaks_arr, weights))


def star_rating(bm: "Beatmap") -> float:
    """classic two-skill star rating for a parsed beatmap; uses the C++
    implementation (native/osudreamer_native.cpp) when built"""
    objs = bm.hit_objects
    if len(objs) < 2:
        return 0.0

    from .. import native

    if native.available():
        pos = np.stack([o.start_pos() for o in objs])
        return native.star_rating(
            np.array([float(o.t) for o in objs]), pos[:, 0], pos[:, 1], bm.cs
        )
    return _star_rating_py(bm)


def _star_rating_py(bm: "Beatmap") -> float:
    """pure-numpy fallback, semantics identical to the C++ path"""
    objs = bm.hit_objects

    radius = _circle_radius(bm.cs)
    scale = _NORMALIZED_RADIUS / radius
    if radius < 30.0:
        scale *= 1.0 + min(30.0 - radius, 5.0) / 50.0

    times = np.array([float(o.t) for o in objs])
    pos = np.stack([o.start_pos() for o in objs]) * scale

    # the classic model clamps ONLY the strain-increment divisor to 50 ms;
    # decay runs on the raw time delta (stacked/0 ms objects decay ~nothing)
    raw_deltas = np.maximum(np.diff(times), 0.0)
    deltas = np.maximum(raw_deltas, _MIN_DELTA_MS)
    dists = np.linalg.norm(np.diff(pos, axis=0), axis=1)

    stars_per_skill = []
    for skill in (SPEED, AIM):
        weight_fn = _speed_spacing_weight if skill == SPEED else _aim_spacing_weight
        decay_base = _DECAY_BASE[skill]
        scaling = _WEIGHT_SCALING[skill]

        strains = np.empty(len(objs))
        strains[0] = 0.0
        for i in range(1, len(objs)):
            increment = weight_fn(float(dists[i - 1])) * scaling / float(deltas[i - 1])
            decay = decay_base ** (float(raw_deltas[i - 1]) / 1000.0)
            strains[i] = strains[i - 1] * decay + increment

        diff = _skill_difficulty(times[1:], strains[1:], decay_base)
        stars_per_skill.append(np.sqrt(diff) * _STAR_SCALE)

    speed_stars, aim_stars = stars_per_skill
    return float(aim_stars + speed_stars + abs(aim_stars - speed_stars) * _EXTREME_SCALE)
