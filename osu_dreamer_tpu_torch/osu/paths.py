"""Slider path geometry: line, perfect-arc and (multi-)bezier curves.

Copy of osu_dreamer_tpu/osu/paths.py. ``slider_from_control_points`` applies
the osu! client's dispatch rules (2 points: line; 3 points: perfect arc with
its degenerate fallbacks; otherwise bezier). ``BezierPath`` is one bezier
segment of any degree: arc length by Gauss-Legendre quadrature of the
hodograph, evaluation and subdivision by de Casteljau. Multi-segment beziers
split at repeated points and are extended or truncated to the declared
length.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .errors import BeatmapParseError
from .events import Slider, Vec2

# osu! clients refuse to render perfect-circle sliders above this radius
MAX_ARC_RADIUS = 320.0
# declared-vs-geometric length mismatches below this many px are ignored
LENGTH_SLACK_PX = 10.0


@lru_cache(maxsize=32)
def _gl_nodes(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights by quadrature order (numpy recomputes
    these from an eigenproblem every call — the slider MAP fitter evaluates
    thousands of candidate lengths per map, so cache by order)"""
    nodes, weights = np.polynomial.legendre.leggauss(order)
    return 0.5 * (nodes + 1.0), weights


class BezierPath:
    """a single bezier segment of arbitrary degree, control points (N, 2)"""

    __slots__ = ("pts", "_length")

    def __init__(self, pts: np.ndarray):
        pts = np.asarray(pts, dtype=float)
        assert pts.ndim == 2 and pts.shape[1] == 2 and pts.shape[0] >= 1
        self.pts = pts
        self._length: float | None = None

    def __repr__(self) -> str:
        return f"BezierPath({self.pts.tolist()})"

    @property
    def n_ctrl(self) -> int:
        return self.pts.shape[0]

    def derivative(self) -> "BezierPath":
        """hodograph: the curve's velocity is itself a bezier of one lower degree"""
        n = self.n_ctrl - 1
        return BezierPath(n * np.diff(self.pts, axis=0))

    @property
    def length(self) -> float:
        """arc length by Gauss-Legendre quadrature of |dp/dt| over [0, 1]"""
        if self._length is None:
            if self.n_ctrl < 2:
                self._length = 0.0
            else:
                order = max(8, int(4 * np.ceil(np.sqrt(self.n_ctrl))))
                t, weights = _gl_nodes(order)
                speed = np.linalg.norm(self.derivative().at(t), axis=1)
                self._length = float(0.5 * np.dot(weights, speed))
        return self._length

    def at(self, t: np.ndarray) -> np.ndarray:
        """evaluate at parameters t, shape (T,) -> (T, 2), by de Casteljau
        vectorized over T (numerically robust at any degree)"""
        t = np.asarray(t, dtype=float)[:, None, None]  # (T,1,1)
        levels = np.broadcast_to(self.pts[None], (t.shape[0], *self.pts.shape)).copy()
        while levels.shape[1] > 1:
            levels = (1.0 - t) * levels[:, :-1] + t * levels[:, 1:]
        return levels[:, 0]

    def param_at_length(self, s: float, tol: float = 1e-3) -> float:
        """parameter t whose arc length from 0 equals ``s`` (bisection on
        the subdivided length — the bezier parameter is NOT proportional to
        arc length, so splitting at a length FRACTION overshoots on curved
        segments)"""
        total = self.length
        if s <= 0.0:
            return 0.0
        if s >= total:
            return 1.0
        lo, hi = 0.0, 1.0
        for _ in range(48):
            mid = 0.5 * (lo + hi)
            if self.split(mid)[0].length < s:
                lo = mid
            else:
                hi = mid
            if (hi - lo) * total < tol:
                break
        return 0.5 * (lo + hi)

    def split(self, t: float) -> tuple["BezierPath", "BezierPath"]:
        """de Casteljau subdivision at t -> (curve over [0,t], curve over [t,1])"""
        assert 0.0 <= t <= 1.0
        head: list[np.ndarray] = []
        tail: list[np.ndarray] = []
        level = self.pts
        while True:
            head.append(level[0])
            tail.append(level[-1])
            if level.shape[0] == 1:
                break
            level = (1.0 - t) * level[:-1] + t * level[1:]
        return BezierPath(np.array(head)), BezierPath(np.array(tail[::-1]))


class LineSlider(Slider):
    """straight-line slider (curve type "L")"""

    __slots__ = ("p0", "p1")

    def __init__(self, *slider_args, start: Vec2, end: Vec2):
        super().__init__(*slider_args)
        self.p0 = np.asarray(start, dtype=float)
        direction = np.asarray(end, dtype=float) - self.p0
        norm = float(np.linalg.norm(direction))
        if self.length > 0 and norm > 0:
            # declared pixel length wins: move the endpoint along the ray
            self.p1 = self.p0 + direction / norm * self.length
            self.ctrl_pts[-1] = self.p1
        else:
            self.p1 = np.asarray(end, dtype=float)
            self.length = norm
            self._refresh_duration()

    def __repr__(self) -> str:
        return f"LineSlider(t={self.t}, {self.p0} -> {self.p1}, x{self.slides})"

    def pos_at(self, f: np.ndarray) -> np.ndarray:
        f = np.asarray(f, dtype=float)[:, None]
        return self.p0 * (1.0 - f) + self.p1 * f

    def vel_at(self, f: np.ndarray) -> np.ndarray:
        v = (self.p1 - self.p0) / self.slide_duration
        return np.broadcast_to(v, (len(f), 2)).copy()


class ArcSlider(Slider):
    """perfect-circle arc slider (curve type "P")"""

    __slots__ = ("center", "radius", "a0", "a1")

    def __init__(self, *slider_args, center: Vec2, radius: float, a0: float, a1: float):
        super().__init__(*slider_args)
        self.center = np.asarray(center, dtype=float)
        self.radius = float(radius)
        self.a0 = float(a0)
        if self.length > 0:
            # declared pixel length wins: sweep exactly length/radius radians
            self.a1 = self.a0 + self.length / self.radius * np.sign(a1 - a0)
            self.ctrl_pts[-1] = self.pos_at(np.ones(1))[0]
        else:
            self.a1 = float(a1)
            self.length = abs(a1 - a0) * self.radius
            self._refresh_duration()

    def __repr__(self) -> str:
        return (
            f"ArcSlider(t={self.t}, O={self.center}, R={self.radius:.1f}, "
            f"{self.a0:.3f} -> {self.a1:.3f}, x{self.slides})"
        )

    def _angles(self, f: np.ndarray) -> np.ndarray:
        f = np.asarray(f, dtype=float)
        return self.a0 * (1.0 - f) + self.a1 * f

    def pos_at(self, f: np.ndarray) -> np.ndarray:
        a = self._angles(f)
        return self.center + self.radius * np.stack([np.cos(a), np.sin(a)], axis=1)

    def vel_at(self, f: np.ndarray) -> np.ndarray:
        a = self._angles(f)
        sweep_rate = (self.a1 - self.a0) / self.slide_duration
        return self.radius * sweep_rate * np.stack([-np.sin(a), np.cos(a)], axis=1)


class MultiBezierSlider(Slider):
    """piecewise-bezier slider (curve type "B"); control points are split into
    segments at repeated points, per the osu! format"""

    __slots__ = ("segments", "seg_ends")

    def __init__(self, *slider_args):
        super().__init__(*slider_args)

        segments = [
            BezierPath(np.array(chunk))
            for chunk in _split_at_repeats(self.ctrl_pts)
            if len(chunk) >= 2
        ]
        if not segments:
            raise BeatmapParseError(f"bezier slider with no valid segments: {self.ctrl_pts}")

        geometric_len = sum(seg.length for seg in segments)

        if self.length > 0:
            gap = self.length - geometric_len
            if abs(gap) < LENGTH_SLACK_PX:
                pass  # close enough; trust the geometry
            elif gap > 0:
                # declared length is longer: extend along the end tangent
                tail = segments[-1].pts
                p = tail[-1]
                v = p - tail[-2]
                v_norm = float(np.linalg.norm(v))
                if v_norm > 0:
                    ext = np.stack([p, p + v / v_norm * gap])
                    segments.append(BezierPath(ext))
                    self.ctrl_pts.extend(list(ext))
            else:
                # declared length is shorter: drop / truncate trailing segments
                excess = geometric_len - self.length
                while segments and excess >= segments[-1].length:
                    excess -= segments.pop().length
                if not segments:
                    raise BeatmapParseError("slider length truncates entire path")
                # PARAMETER-fraction split, matching the reference parser
                # exactly (reference sliders.py:205): the osu! client cuts
                # at exact ARC length instead (the bezier parameter is not
                # proportional to arc length, so this overshoots by up to
                # ~10% on curved last segments) — kept reference-compatible
                # because the parity suite treats the reference codec as
                # the dataset-encoding oracle. param_at_length() is the
                # client-accurate alternative if that trade ever flips.
                keep_frac = 1.0 - excess / max(segments[-1].length, 1e-12)
                segments[-1] = segments[-1].split(min(max(keep_frac, 0.0), 1.0))[0]
                self.ctrl_pts = [p for seg in segments for p in seg.pts]
        else:
            self.length = geometric_len
            self._refresh_duration()

        self.segments = segments
        lens = np.array([max(seg.length, 1e-12) for seg in segments])
        self.seg_ends = np.cumsum(lens) / lens.sum()

    def __repr__(self) -> str:
        return f"MultiBezierSlider(t={self.t}, {len(self.segments)} segs, x{self.slides})"

    def _localize(self, f: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """map global slide fraction -> (segment index, within-segment parameter)"""
        f = np.clip(np.asarray(f, dtype=float), 0.0, 1.0)
        idx = np.searchsorted(self.seg_ends, f)
        idx = np.minimum(idx, len(self.segments) - 1)
        starts = np.concatenate([[0.0], self.seg_ends])[idx]
        spans = np.maximum(self.seg_ends[idx] - starts, 1e-12)
        return idx, (f - starts) / spans

    def _eval(self, f: np.ndarray, derivative: bool) -> np.ndarray:
        f = np.asarray(f, dtype=float)
        if f.shape[0] == 0:
            return np.empty((0, 2))
        idx, local_t = self._localize(f)
        out = np.empty((f.shape[0], 2))
        # batch all queries that land on the same segment (one de Casteljau per
        # segment, not per query point)
        for seg_i in np.unique(idx):
            sel = idx == seg_i
            seg = self.segments[seg_i]
            curve = seg.derivative() if derivative else seg
            out[sel] = curve.at(local_t[sel])
        return out

    def pos_at(self, f: np.ndarray) -> np.ndarray:
        return self._eval(f, derivative=False)

    def vel_at(self, f: np.ndarray) -> np.ndarray:
        return self._eval(f, derivative=True) / self.slide_duration


def _split_at_repeats(pts: list[Vec2]) -> list[list[Vec2]]:
    """split the control-point list into segment chunks at repeated points
    (the osu! format marks segment boundaries by duplicating a point)"""
    chunks: list[list[Vec2]] = []
    chunk_start = 0
    for i in range(1, len(pts)):
        if np.array_equal(pts[i - 1], pts[i]):
            chunks.append(pts[chunk_start:i])
            chunk_start = i
    chunks.append(pts[chunk_start:])
    return chunks


def _cross2(u: Vec2, v: Vec2) -> float:
    """z-component of the 2-D cross product"""
    return float(u[0] * v[1] - u[1] * v[0])


def _circumcircle(a: Vec2, b: Vec2, c: Vec2) -> tuple[Vec2, float]:
    """circumcenter and circumradius of triangle abc via barycentric weights"""
    la = float(np.dot(c - b, c - b))
    lb = float(np.dot(c - a, c - a))
    lc = float(np.dot(b - a, b - a))
    wa = la * (lb + lc - la)
    wb = lb * (la + lc - lb)
    wc = lc * (la + lb - lc)
    w = wa + wb + wc
    center = (wa * a + wb * b + wc * c) / w
    radius = float(np.sqrt(la * lb * lc)) / (4.0 * _triangle_area(a, b, c))
    return center, radius


def _triangle_area(a: Vec2, b: Vec2, c: Vec2) -> float:
    return abs(_cross2(b - a, c - b)) / 2.0


def slider_from_control_points(
    t: int,
    beat_length: float,
    slider_mult: float,
    new_combo: bool,
    hit_sound: int,
    slides: int,
    length: float,
    ctrl_pts: list[Vec2],
) -> Slider:
    """construct the concrete slider for a control-point list, applying the
    osu! client's degenerate-case rules (reference sliders.py:11-69)"""
    args = (t, beat_length, slider_mult, new_combo, hit_sound, slides, length, ctrl_pts)

    if len(ctrl_pts) < 2:
        raise BeatmapParseError(f"slider needs at least 2 control points: {ctrl_pts}")

    if len(ctrl_pts) == 2:
        return LineSlider(*args, start=ctrl_pts[0], end=ctrl_pts[1])

    if len(ctrl_pts) == 3:
        a, b, c = ctrl_pts

        if np.array_equal(b, c):
            # repeated endpoint: renders as a straight line
            ctrl_pts.pop(1)
            return LineSlider(*args, start=a, end=c)

        turn = _cross2(b - a, c - b)
        if turn == 0.0:
            # collinear control points
            if float(np.dot(b - a, c - b)) > 0:
                # monotone a--b--c: plain line
                ctrl_pts.pop(1)
                return LineSlider(*args, start=a, end=c)
            # doubles back (a--c--b): render as a bezier [a, b, b, c]
            ctrl_pts.insert(1, ctrl_pts[1])
            return MultiBezierSlider(*args)

        center, radius = _circumcircle(a, b, c)

        if radius > MAX_ARC_RADIUS and float(np.dot(c - b, b - a)) < 0:
            # arc too large to render AND the path backtracks: bezier fallback
            return MultiBezierSlider(*args)

        a0 = float(np.arctan2(*(a - center)[::-1]))
        a1 = float(np.arctan2(*(c - center)[::-1]))
        if turn < 0:  # clockwise: sweep end angle downward past the start
            while a1 > a0:
                a1 -= 2 * np.pi
        else:  # counter-clockwise
            while a0 > a1:
                a0 -= 2 * np.pi

        return ArcSlider(*args, center=center, radius=radius, a0=a0, a1=a1)

    return MultiBezierSlider(*args)
