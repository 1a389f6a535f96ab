"""osu! domain layer: .osu beatmap parsing and hit-object geometry (copy of
osu_dreamer_tpu/osu/)."""

from .beatmap import Beatmap
from .errors import BeatmapParseError
from .events import Break, Circle, HitObject, Slider, Spinner, Timed, TimingPoint
from .paths import BezierPath, slider_from_control_points

__all__ = [
    "Beatmap",
    "BeatmapParseError",
    "BezierPath",
    "Break",
    "Circle",
    "HitObject",
    "Slider",
    "Spinner",
    "Timed",
    "TimingPoint",
    "slider_from_control_points",
]
