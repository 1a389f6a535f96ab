"""Empirical prior over slider families for the MAP curve selection.

Copy of osu_dreamer_tpu/signal/fit/prior.py. Families: P (perfect arc), L
(line), B/n (one bezier of n control points), PL/m and PB/m (poly-line and
poly-bezier of m segments). Family frequencies P .4924, L .3531, PL .0869,
PB .0383, B .0294; poly segment counts follow a zeta(4) law over m >= 2; a
single bezier's control-point count is a cubic spike (w .5991) mixed with a
geometric tail (q .7431).
"""

from __future__ import annotations

from math import exp, log

from scipy.special import zeta

FAMILY_LOG_PROB = {
    "P": log(0.4924),
    "L": log(0.3531),
    "PL": log(0.0869),
    "PB": log(0.0383),
    "B": log(0.0294),
}

SEGMENT_POWER = 4  # zeta exponent for poly segment counts
CUBIC_WEIGHT = 0.5991  # mixture weight of the cubic spike
DEGREE_DECAY = 0.7431  # geometric ratio of the degree tail


def _zeta_log_pmf(k: int, k_min: int) -> float:
    """log P(k) under a zeta(SEGMENT_POWER) law truncated to k >= k_min"""
    norm = zeta(SEGMENT_POWER) - sum(j ** -SEGMENT_POWER for j in range(1, k_min))
    return -SEGMENT_POWER * log(k) - log(norm)


def log_prior_arc() -> float:
    return FAMILY_LOG_PROB["P"]


def log_prior_single_bezier(n_ctrl: int) -> float:
    """a 2-point 'bezier' is just a line; higher degrees pay the B family
    probability times the spike+tail degree distribution"""
    if n_ctrl <= 2:
        return FAMILY_LOG_PROB["L"]
    w, q = CUBIC_WEIGHT, DEGREE_DECAY
    log_tail = log(1 - w) + log(1 - q) + (n_ctrl - 3) * log(q)
    if n_ctrl == 4:
        # spike + tail, combined in log space
        m = max(log(w), log_tail)
        log_degree = m + log(exp(log(w) - m) + exp(log_tail - m))
    else:
        log_degree = log_tail
    return FAMILY_LOG_PROB["B"] + log_degree


def log_prior_poly(n_segments: int, all_lines: bool) -> float:
    family = "PL" if all_lines else "PB"
    return FAMILY_LOG_PROB[family] + _zeta_log_pmf(n_segments, k_min=2)
