"""Bezier least squares on the Bernstein basis.

Copy of osu_dreamer_tpu/signal/fit/bezier_fit.py: one segment with optional
endpoint pinning, solved through cached projectors, and poly-bezier fits
grown by splitting the worst span at its largest residual. Points are
(L, 2), evenly spaced in the curve parameter.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterator

import numpy as np
from scipy.special import comb

from ...osu.paths import BezierPath


def bernstein_basis(t: np.ndarray, n_ctrl: int) -> np.ndarray:
    """(L, n_ctrl) matrix of Bernstein polynomials of degree n_ctrl-1 at t"""
    d = n_ctrl - 1
    i = np.arange(n_ctrl)
    return comb(d, i) * t[:, None] ** i * (1.0 - t[:, None]) ** (d - i)


@lru_cache(maxsize=4096)
def _basis_uniform(L: int, n_ctrl: int) -> np.ndarray:
    """Bernstein basis on the uniform L-point parameter grid. The MAP fitter
    evaluates thousands of (span length, degree) candidates per map, with
    heavy repetition — cache the (tiny) matrices"""
    b = bernstein_basis(np.linspace(0.0, 1.0, L), n_ctrl)
    b.setflags(write=False)
    return b


@lru_cache(maxsize=4096)
def _solver(L: int, n_ctrl: int, pin_start: bool, pin_end: bool):
    """projector onto the free control points for the (span length, degree,
    endpoint-pin) pattern. The whole least-squares system depends only on
    this key — the MAP search re-solves it thousands of times per map with
    different right-hand sides, so cache `P = (Tf'Tf)^-1 Tf'` once and each
    fit is two small matmuls."""
    T = _basis_uniform(L, n_ctrl)
    free = np.ones(n_ctrl, dtype=bool)
    if pin_start:
        free[0] = False
    if pin_end:
        free[-1] = False
    Tf = T[:, free]
    # normal equations (degrees are small, float64 handles the squared
    # conditioning); an (under)determined system — possible only outside the
    # MAP search's n_ctrl <= L envelope — falls back to the min-norm pinv
    gram = Tf.T @ Tf
    if Tf.shape[1] == 0:  # fully pinned (2-point segment): nothing to solve
        P = Tf.T
    elif Tf.shape[0] < Tf.shape[1] or np.linalg.cond(gram) > 1e12:
        P = np.linalg.pinv(Tf)
    else:
        P = np.linalg.solve(gram, Tf.T)
    for a in (T, free, P):
        a.setflags(write=False)
    return T, free, P


def _fit_segment_resid(
    points: np.ndarray, n_ctrl: int, pin_start: bool, pin_end: bool
) -> tuple[BezierPath, np.ndarray]:
    """core fit; returns (curve, per-point residual vectors (L, 2))"""
    T, free, P = _solver(points.shape[0], n_ctrl, pin_start, pin_end)

    ctrl = np.empty((n_ctrl, 2))
    if pin_start:
        ctrl[0] = points[0]
    if pin_end:
        ctrl[-1] = points[-1]

    # move pinned columns to the right-hand side, project for the free ones
    rhs = points
    if not free.all():
        rhs = points - T[:, ~free] @ ctrl[~free]
    ctrl[free] = P @ rhs

    return BezierPath(ctrl), T @ ctrl - points


def fit_segment(
    points: np.ndarray,
    n_ctrl: int,
    pin_start: bool = False,
    pin_end: bool = False,
) -> tuple[BezierPath, float]:
    """least-squares bezier through `points` (L, 2); pinned endpoints are
    clamped to the data endpoints (keeps adjacent poly-segments joined).
    returns (curve, sum of squared residuals)"""
    curve, resid = _fit_segment_resid(points, n_ctrl, pin_start, pin_end)
    return curve, float((resid**2).sum())


def fit_poly(
    points: np.ndarray,
    n_ctrl: int,
    max_segments: int,
) -> Iterator[tuple[list[BezierPath], float]]:
    """yields joined multi-segment fits with 2..max_segments segments, grown
    by splitting the worst-fitting span at its largest-residual point. every
    segment has (up to) `n_ctrl` control points; n_ctrl=2 gives a poly-line."""
    L = points.shape[0]

    def fit_span(lo: int, hi: int) -> tuple[BezierPath, float, int]:
        span = points[lo : hi + 1]
        curve, resid = _fit_segment_resid(
            span,
            min(n_ctrl, span.shape[0]),
            pin_start=lo != 0,
            pin_end=hi != L - 1,
        )
        per_point = (resid**2).sum(axis=1)
        return curve, float(per_point.sum()), lo + int(per_point.argmax())

    spans: list[tuple[int, int]] = [(0, L - 1)]
    fits = [fit_span(0, L - 1)]

    for _ in range(max_segments - 1):
        splittable = [k for k, (lo, hi) in enumerate(spans) if hi - lo >= 2]
        if not splittable:
            return
        k = max(splittable, key=lambda k: fits[k][1])
        lo, hi = spans[k]
        cut = fits[k][2]
        if not lo < cut < hi:
            cut = (lo + hi) // 2

        spans[k : k + 1] = [(lo, cut), (cut, hi)]
        fits[k : k + 1] = [fit_span(lo, cut), fit_span(cut, hi)]

        yield [f[0] for f in fits], float(sum(f[1] for f in fits))
