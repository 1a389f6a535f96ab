"""Slider curve fitting: editable slider control points from the dense
predicted cursor path (copy of osu_dreamer_tpu/signal/fit/)."""

from .select import fit_slider

__all__ = ["fit_slider"]
