"""MAP slider-curve selection with branch-and-bound.

Copy of osu_dreamer_tpu/signal/fit/select.py. Each candidate curve costs
``sse / (2 * noise^2) - log P(family)`` (gaussian cursor noise of 16 px);
since sse >= 0 a family's prior penalty bounds its cost from below, so
families are visited cheapest prior first and the search stops when none
left can beat the best so far. ``fit_slider`` takes the C++ fitter
(``odn_fit_slider``, through the port's ``native`` binding) when it is
loaded; the numpy path here is the oracle the tests hold it to.
"""

from __future__ import annotations

import numpy as np

from .arc_fit import fit_arc
from .bezier_fit import fit_poly, fit_segment
from .prior import log_prior_arc, log_prior_poly, log_prior_single_bezier

# expected cursor noise in osu!px: larger trusts the prior more (simpler curves)
NOISE_SCALE_PX = 16.0
MAX_SINGLE_BEZIER_CTRL = 8
MAX_POLY_SEGMENTS = 16

# log-prior tables for the native fitter, built once: the C++ path takes the
# SAME constants (prior.py) so the two implementations never drift
_NATIVE_PRIORS: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None


def _native_priors() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    global _NATIVE_PRIORS
    if _NATIVE_PRIORS is None:
        lp_single = np.zeros(MAX_SINGLE_BEZIER_CTRL + 1)
        for k in range(2, MAX_SINGLE_BEZIER_CTRL + 1):
            lp_single[k] = log_prior_single_bezier(k)
        lp_line = np.zeros(MAX_POLY_SEGMENTS + 2)
        lp_bez = np.zeros(MAX_POLY_SEGMENTS + 2)
        for m in range(1, MAX_POLY_SEGMENTS + 2):
            lp_line[m] = log_prior_poly(m, True)
            lp_bez[m] = log_prior_poly(m, False)
        _NATIVE_PRIORS = (lp_single, lp_line, lp_bez)
    return _NATIVE_PRIORS


def fit_slider(
    cursor_xy: np.ndarray,
    start_idx: int,
    end_idx: int,
    num_repeats: int,
    noise_scale: float = NOISE_SCALE_PX,
    use_native: bool | None = None,
) -> tuple[str, float, list[np.ndarray]]:
    """fit the best slider curve to one slide of the cursor path.

    `cursor_xy` is the (2, L) cursor signal in osu!px; the slider spans frames
    [start_idx, end_idx] and traverses its path `num_repeats` times, so only
    the first slide's worth of frames is fitted.

    returns (curve type "P"|"B", pixel length, integer control points);
    length 0 signals a degenerate slider the caller should emit as a circle.

    ``use_native`` selects the C++ fitter (native/osudreamer_native.cpp
    odn_fit_slider; default: whenever the library is loaded). The numpy path
    below is the semantics oracle — tests assert the two agree.
    """
    one_slide_end = round(start_idx + (end_idx - start_idx) / num_repeats)
    points = cursor_xy[:, start_idx : one_slide_end + 1].T  # (L, 2)
    if points.shape[0] < 2:
        return "B", 0.0, []

    if use_native is not False:
        from ... import native

        if native.available():
            return _fit_slider_native(points, noise_scale)
        if use_native:
            raise RuntimeError("native fitter requested but no g++ builds the native library")

    inv_two_var = 1.0 / (2.0 * noise_scale**2)

    best_cost = np.inf
    # (type, curve list | precomputed (length, ctrl)) — lengths and integer
    # control points are only materialized for the winner: GL-quadrature
    # lengths + rounding across every candidate was ~40% of fitter time
    best_type = "B"
    best_curves: list = []
    best_final: tuple[float, list[np.ndarray]] | None = (0.0, [])

    def consider(cost: float, curve_type: str, curves: list) -> bool:
        nonlocal best_cost, best_type, best_curves, best_final
        # `not (cost < best)` rather than `cost >= best`: a NaN cost (NaN
        # cursor input) must never win, and must not poison the pruning
        if not (cost < best_cost):
            return False
        best_cost = cost
        best_type = curve_type
        best_curves = curves
        best_final = None
        return True

    # 1. perfect arc (length/ctrl come out of the fit itself — precomputed)
    arc = fit_arc(points)
    if arc is not None:
        sse, length, ctrl = arc
        if consider(sse * inv_two_var - log_prior_arc(), "P", []):
            best_final = (length, ctrl)

    # 2. single bezier, cheapest prior first (the prior is not monotonic in
    #    degree: the cubic spike beats the quadratic)
    candidates = sorted(
        (-log_prior_single_bezier(n), n)
        for n in range(2, min(MAX_SINGLE_BEZIER_CTRL, points.shape[0]) + 1)
    )
    for penalty, n_ctrl in candidates:
        if penalty >= best_cost:
            break  # all remaining single beziers pay at least this much
        curve, sse = fit_segment(points, n_ctrl)
        consider(sse * inv_two_var + penalty, "B", [curve])

    # 3. poly-line then poly-bezier, growing segment counts
    for n_ctrl, all_lines in ((2, True), (4, False)):
        if -log_prior_poly(2, all_lines) >= best_cost:
            continue  # even this family's cheapest member can't win
        for curves, sse in fit_poly(points, n_ctrl, MAX_POLY_SEGMENTS):
            m = len(curves)
            consider(
                sse * inv_two_var - log_prior_poly(m, all_lines),
                "B",
                list(curves),
            )
            if -log_prior_poly(m + 1, all_lines) >= best_cost:
                break  # the penalty only grows from here

    if best_final is None:
        length = float(sum(c.length for c in best_curves))
        # concatenated segments reproduce osu!'s repeated-point boundaries
        ctrl = [p.round().astype(int) for c in best_curves for p in c.pts]
        best_final = (length, ctrl)
    return best_type, best_final[0], best_final[1]


def _fit_slider_native(
    points: np.ndarray, noise_scale: float
) -> tuple[str, float, list[np.ndarray]]:
    """C++ MAP fit of one slide span (points (L, 2)); same contract as the
    numpy path above. Control points come back unrounded so the np.round
    here (half-to-even) matches the numpy path's rounding exactly."""
    import ctypes
    from ctypes import POINTER, c_char, c_double, c_int32

    from ... import native

    lib = native._load()
    assert lib is not None
    lp_single, lp_line, lp_bez = _native_priors()
    pts = np.ascontiguousarray(points, np.float64)
    out_ctrl = np.empty((MAX_POLY_SEGMENTS * 4, 2), np.float64)
    out_type = ctypes.create_string_buffer(2)
    out_length = c_double()
    out_n = c_int32()

    def dptr(a: np.ndarray):
        return a.ctypes.data_as(POINTER(c_double))

    rc = lib.odn_fit_slider(
        dptr(pts), pts.shape[0], 1.0 / (2.0 * noise_scale**2),
        log_prior_arc(), dptr(lp_single), MAX_SINGLE_BEZIER_CTRL,
        dptr(lp_line), dptr(lp_bez), MAX_POLY_SEGMENTS,
        out_type, ctypes.byref(out_length), dptr(out_ctrl), ctypes.byref(out_n),
    )
    if rc != 0 or out_n.value == 0:
        return "B", 0.0, []
    ctrl = [p.round().astype(int) for p in out_ctrl[: out_n.value]]
    return out_type.value.decode(), float(out_length.value), ctrl
