"""Timed beatmap objects: timing points, breaks and hit objects.

Copy of osu_dreamer_tpu/osu/events.py (the port imports nothing of the JAX
package): ``Slider.slide_duration = length / (slider_mult * 100) *
beat_length``, ``end_time = t + slide_duration * slides``; whistle, finish and
clap hit-sound bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

Vec2 = np.ndarray  # shape (2,), float64

PLAYFIELD_CENTER = np.array([256.0, 192.0])

# hit-sound bit flags ([HitObjects] column 4 of the .osu format)
WHISTLE_BIT = 1 << 1
FINISH_BIT = 1 << 2
CLAP_BIT = 1 << 3


@dataclass(slots=True, eq=False)
class Timed:
    """anything with a millisecond timestamp; orders by time"""

    t: int

    def __post_init__(self) -> None:
        self.t = int(self.t)

    def __lt__(self, other: "Timed") -> bool:
        return self.t < other.t


@dataclass(slots=True, eq=False)
class TimingPoint(Timed):
    beat_length: float
    slider_mult: float
    meter: int

    def same_effect(self, other: "TimingPoint") -> bool:
        """true when this point changes nothing relative to `other`"""
        return (
            self.beat_length == other.beat_length
            and self.slider_mult == other.slider_mult
            and self.meter == other.meter
        )


@dataclass(slots=True)
class Break(Timed):
    u: int  # end time (ms)

    def end_time(self) -> int:
        return self.u


class HitObject(Timed):
    """base for circles / sliders / spinners"""

    __slots__ = ("new_combo", "whistle", "finish", "clap")

    def __init__(self, t: int, new_combo: bool, hit_sound: int):
        super().__init__(t)
        self.new_combo = new_combo
        self.whistle = bool(hit_sound & WHISTLE_BIT)
        self.finish = bool(hit_sound & FINISH_BIT)
        self.clap = bool(hit_sound & CLAP_BIT)

    def end_time(self) -> int:
        raise NotImplementedError

    def start_pos(self) -> Vec2:
        raise NotImplementedError

    def end_pos(self) -> Vec2:
        return self.start_pos()


class Circle(HitObject):
    __slots__ = ("x", "y")

    def __init__(self, t: int, new_combo: bool, hit_sound: int, x: int, y: int):
        super().__init__(t, new_combo, hit_sound)
        self.x = x
        self.y = y

    def __repr__(self) -> str:
        return f"Circle(t={self.t}, xy=({self.x},{self.y}))"

    def end_time(self) -> int:
        return self.t

    def start_pos(self) -> Vec2:
        return np.array([self.x, self.y], dtype=float)


class Spinner(HitObject):
    __slots__ = ("u",)

    def __init__(self, t: int, new_combo: bool, hit_sound: int, u: int):
        super().__init__(t, new_combo, hit_sound)
        self.u = u

    def __repr__(self) -> str:
        return f"Spinner(t={self.t}, u={self.u})"

    def end_time(self) -> int:
        return self.u

    def start_pos(self) -> Vec2:
        return PLAYFIELD_CENTER.copy()


class Slider(HitObject):
    """abstract slider; concrete path shapes live in osu/paths.py

    ``slide_duration`` is the time of ONE traversal of the path; repeats
    (``slides`` > 1) reflect back and forth.
    """

    __slots__ = ("slides", "length", "beat_length", "slider_mult", "ctrl_pts", "slide_duration")

    def __init__(
        self,
        t: int,
        beat_length: float,
        slider_mult: float,
        new_combo: bool,
        hit_sound: int,
        slides: int,
        length: float,
        ctrl_pts: list[Vec2],
    ):
        super().__init__(t, new_combo, hit_sound)
        self.slides = slides
        self.length = length
        self.beat_length = beat_length
        self.slider_mult = slider_mult
        self.ctrl_pts = ctrl_pts
        self.slide_duration = length / (slider_mult * 100) * beat_length

    def _refresh_duration(self) -> None:
        """recompute slide_duration after a subclass fixes ``length`` from
        geometry (a declared length of 0 would otherwise leave
        slide_duration at 0: end_time()==t, zero-width encoded extents, and
        vel_at dividing by zero)"""
        self.slide_duration = (
            self.length / (self.slider_mult * 100) * self.beat_length
        )

    def end_time(self) -> int:
        return int(self.t + self.slide_duration * self.slides)

    def pos_at(self, f: np.ndarray) -> np.ndarray:
        """cursor position for slide fractions `f` in [0,1]; shape (L,) -> (L,2)"""
        raise NotImplementedError

    def vel_at(self, f: np.ndarray) -> np.ndarray:
        """cursor velocity (px/ms) for slide fractions `f`; shape (L,) -> (L,2)"""
        raise NotImplementedError

    # aliases matching the reference public surface (sliders.py lerp/vel)
    def lerp(self, f: np.ndarray) -> np.ndarray:
        return self.pos_at(f)

    def vel(self, f: np.ndarray) -> np.ndarray:
        return self.vel_at(f)

    def start_pos(self) -> Vec2:
        return self.pos_at(np.zeros(1))[0]

    def end_pos(self) -> Vec2:
        # odd number of slides ends at the far end, even ends back at the start
        return self.pos_at(np.array([float(self.slides % 2)]))[0]
