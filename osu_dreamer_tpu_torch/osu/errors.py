"""Copy of osu_dreamer_tpu/osu/errors.py: the parse-error sentinel."""


class BeatmapParseError(Exception):
    """raised when a .osu file cannot be interpreted as a valid std beatmap"""
