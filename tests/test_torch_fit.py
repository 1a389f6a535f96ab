"""The port's MAP slider fitter and its native binding on the CPU.

- the numpy fitter (``use_native=False``) equals the JAX one exactly: the
  same family, the same length and the same integer control points, on arcs,
  lines, cubic beziers and random walks (tests/test_native.py's families,
  20 trials each), on repeats, a one-frame span and a NaN cursor;
- the prior tables the C++ fitter reads equal the JAX ones;
- the port's C++ fitter, built by its own binding from native/*.cpp, against
  the numpy oracle under tests/test_native.py's rule (same family and
  control points, length within max(1e-6 length, 1e-3)), skipped only where
  no g++ exists;
- two processes building the binding at the same moment both load it.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ["arc", "line", "bezier", "walk"]


def _shapes(rng, kind: int):
    """tests/test_native.py's slider families: (2, L) cursor paths in px"""
    L = int(rng.integers(5, 150))
    t = np.linspace(0, 1, L)
    if kind == 0:  # arc
        th = rng.uniform(0.3, 2.8)
        r = rng.uniform(30, 300)
        c = rng.uniform(100, 300, 2)
        xy = c[:, None] + r * np.vstack([np.cos(th * t), np.sin(th * t)])
    elif kind == 1:  # line
        p0, p1 = rng.uniform(0, 400, 2), rng.uniform(0, 400, 2)
        xy = p0[:, None] * (1 - t) + p1[:, None] * t
    elif kind == 2:  # cubic bezier
        P = rng.uniform(0, 400, (4, 2))
        B = np.array([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t ** 2 * (1 - t), t ** 3])
        xy = P.T @ B
    else:  # wiggly random walk (forces poly families)
        xy = np.cumsum(rng.normal(0, 8, (2, L)), axis=1) + 200
    return xy + rng.normal(0, 2.0, xy.shape), L


def _same(a, b) -> None:
    (ta, la, ca), (tb, lb, cb) = a, b
    assert ta == tb and la == lb and len(ca) == len(cb), (a, b)
    for p, q in zip(ca, cb):
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_fitter_matches_jax(family):
    from osu_dreamer_tpu.signal.fit.select import fit_slider as jfit
    from osu_dreamer_tpu_torch.signal.fit.select import fit_slider as tfit

    rng = np.random.default_rng(1234 + FAMILIES.index(family))
    for _ in range(20):
        xy, L = _shapes(rng, FAMILIES.index(family))
        _same(tfit(xy, 0, L - 1, 1, use_native=False), jfit(xy, 0, L - 1, 1, use_native=False))


@pytest.mark.parametrize("case", ["repeats", "one_frame", "offset_span", "nan"])
def test_numpy_fitter_edge_cases_match_jax(case):
    from osu_dreamer_tpu.signal.fit.select import fit_slider as jfit
    from osu_dreamer_tpu_torch.signal.fit.select import fit_slider as tfit

    rng = np.random.default_rng(7)
    xy = np.cumsum(rng.normal(0, 6, (2, 90)), axis=1) + 200
    span = {"repeats": (0, 89, 3), "one_frame": (4, 4, 1), "offset_span": (17, 70, 2),
            "nan": (0, 39, 1)}[case]
    if case == "nan":
        xy = np.full((2, 40), np.nan)
    got = tfit(xy, *span, use_native=False)
    _same(got, jfit(xy, *span, use_native=False))
    if case == "one_frame":
        assert got[1] == 0.0
    if case == "nan":
        assert got[0] in ("P", "B")


def test_prior_tables_match_jax():
    from osu_dreamer_tpu.signal.fit import prior as jprior
    from osu_dreamer_tpu.signal.fit import select as jselect
    from osu_dreamer_tpu_torch.signal.fit import prior as tprior
    from osu_dreamer_tpu_torch.signal.fit import select as tselect

    for got, want in zip(tselect._native_priors(), jselect._native_priors()):
        np.testing.assert_array_equal(got, want)
    assert tprior.FAMILY_LOG_PROB == jprior.FAMILY_LOG_PROB
    assert tprior.log_prior_arc() == jprior.log_prior_arc()
    for name in ("NOISE_SCALE_PX", "MAX_SINGLE_BEZIER_CTRL", "MAX_POLY_SEGMENTS"):
        assert getattr(tselect, name) == getattr(jselect, name)


@pytest.fixture
def port_native():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port's native library cannot be built here")
    from osu_dreamer_tpu_torch import native

    assert native.available()
    return native


@pytest.mark.parametrize("family", FAMILIES)
def test_native_fitter_matches_numpy_oracle(port_native, family):
    """tests/test_native.py's rule, the port's C++ fitter against the JAX
    numpy fitter"""
    from osu_dreamer_tpu.signal.fit.select import fit_slider as jfit
    from osu_dreamer_tpu_torch.signal.fit.select import fit_slider as tfit

    rng = np.random.default_rng(1234 + FAMILIES.index(family))
    for trial in range(20):
        xy, L = _shapes(rng, FAMILIES.index(family))
        tn, ln, cn = tfit(xy, 0, L - 1, 1, use_native=True)
        tp, lp, cp = jfit(xy, 0, L - 1, 1, use_native=False)
        assert tn == tp, f"trial {trial}: family {tn} != {tp}"
        assert abs(ln - lp) < max(1e-6 * max(lp, 1.0), 1e-3), (trial, ln, lp)
        assert len(cn) == len(cp), (trial, len(cn), len(cp))
        for a, b in zip(cn, cp):
            assert (a == b).all(), (trial, a, b)
    # fit_slider takes the C++ fitter by default once the library is loaded
    xy, L = _shapes(rng, FAMILIES.index(family))
    _same(tfit(xy, 0, L - 1, 1), tfit(xy, 0, L - 1, 1, use_native=True))


def test_native_library_lands_in_build(port_native):
    """the binding builds from native/*.cpp into build/native/, named by a
    hash; nothing is written into the JAX package"""
    path = port_native.build("osudreamer_native.cpp")
    assert path.parent == REPO / "build" / "native"
    assert path.name.startswith("libosudreamer_native_") and path.suffix == ".so"
    assert port_native.SOURCES == REPO / "native"


BUILD_ONE = """
import sys
from pathlib import Path
from osu_dreamer_tpu_torch import native

native.BUILD_DIR = Path(sys.argv[1])
print(native.available(), native.star_rating([0.0, 300.0, 600.0], [0.0, 100.0, 0.0],
                                             [0.0, 0.0, 100.0], 4.0) > 0)
"""


def test_concurrent_first_builds_both_load(tmp_path):
    """two processes start the first build into one empty directory at the
    same moment: each compiles in its own temporary file and moves it into
    place, so both load a whole library and one library is left"""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port's native library cannot be built here")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["True", "True"], out
    assert [f.name.rsplit("_", 1)[0] for f in tmp_path.iterdir()] == ["libosudreamer_native"]


def test_missing_compiler_means_numpy_paths(monkeypatch, tmp_path):
    """no g++: ``available()`` is False and the fitter takes the numpy path;
    asking for the C++ fitter then raises"""
    from osu_dreamer_tpu_torch import native
    from osu_dreamer_tpu_torch.signal.fit.select import fit_slider

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native._load.cache_clear()
    native._load_av.cache_clear()
    try:
        assert not native.available() and not native.av_available()
        xy = np.cumsum(np.random.default_rng(3).normal(0, 6, (2, 40)), axis=1) + 200
        _same(fit_slider(xy, 0, 39, 1), fit_slider(xy, 0, 39, 1, use_native=False))
        with pytest.raises(RuntimeError, match="native fitter requested"):
            fit_slider(xy, 0, 39, 1, use_native=True)
    finally:
        native._load.cache_clear()
        native._load_av.cache_clear()
    assert not list(tmp_path.iterdir())


def test_failing_compiler_raises(monkeypatch, tmp_path):
    """a g++ that is found and fails raises rather than falling back"""
    from osu_dreamer_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "SOURCES", tmp_path)
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port's native library cannot be built here")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build("broken.cpp")
