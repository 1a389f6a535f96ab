"""Perfect-arc fitting: algebraic (Kasa) circle least squares and the
renderability gates.

Copy of osu_dreamer_tpu/signal/fit/arc_fit.py: at least 3 points, endpoints
at least 15 px apart, radius at most 320, sweep at least .05 rad and under a
full turn, at most 25 % angular reversals; emits the 3-point P control
polygon (start, arc midpoint, end).
"""

from __future__ import annotations

import numpy as np

MIN_ENDPOINT_DIST = 15.0
MAX_RADIUS = 320.0
MIN_SWEEP_RAD = 0.05
MAX_REVERSAL_FRAC = 0.25


def fit_arc(points: np.ndarray) -> tuple[float, float, list[np.ndarray]] | None:
    """fit a circular arc to `points` (L, 2). returns (sse, arc length,
    control points) or None when the points don't form a renderable arc"""
    if points.shape[0] < 3:
        return None

    x, y = points[:, 0], points[:, 1]

    # Kasa fit: minimize |(x-cx)^2 + (y-cy)^2 - r^2| linearized over (cx, cy, c)
    design = np.column_stack([2 * x, 2 * y, np.ones_like(x)])
    target = x * x + y * y
    # no fit needed to reject a degenerate span: check endpoints first
    if np.linalg.norm(points[-1] - points[0]) < MIN_ENDPOINT_DIST:
        return None

    try:
        (cx, cy, c), *_ = np.linalg.lstsq(design, target, rcond=None)
    except np.linalg.LinAlgError:
        return None

    r_sq = cx * cx + cy * cy + c
    if r_sq <= 0:
        return None
    radius = float(np.sqrt(r_sq))
    center = np.array([cx, cy])

    if radius > MAX_RADIUS:
        return None

    angles = np.unwrap(np.arctan2(y - cy, x - cx))
    sweep = float(angles[-1] - angles[0])
    if abs(sweep) < MIN_SWEEP_RAD:
        return None
    # a 3-point "P" spec cannot represent a sweep of a full circle or more:
    # the midpoint wraps and the reconstructed arc plays MIRRORED
    if abs(sweep) >= 2.0 * np.pi:
        return None

    # angular-direction reversals: exactly-repeated cursor points (uint16
    # quantization, rests) give zero steps — not reversals
    steps = np.diff(angles)
    nonzero = steps[steps != 0.0]
    if np.count_nonzero(
        np.sign(nonzero) != np.sign(sweep)
    ) > len(steps) * MAX_REVERSAL_FRAC:
        return None

    radial_err = np.linalg.norm(points - center, axis=1) - radius
    sse = float((radial_err**2).sum())

    mid_angle = angles[0] + sweep / 2.0
    midpoint = center + radius * np.array([np.cos(mid_angle), np.sin(mid_angle)])
    ctrl = [
        points[0].round().astype(int),
        midpoint.round().astype(int),
        points[-1].round().astype(int),
    ]
    return sse, abs(sweep) * radius, ctrl
