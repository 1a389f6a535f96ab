"""The encode side of the port's signal codec against the JAX package on the
CPU: on the six fixture beatmaps, ``hit_signal``, ``cursor_signal``,
``timing_signal`` and ``get_labels``; ``write_beatmap``'s map files read back
through both packages' ``read_beatmap``; the NaN refusal; and the port's C++
star rating against its numpy one.

Tolerance: none for the codec. Both sides run the same numpy statements on
maps parsed by copies of one parser, with both packages' ``native`` pinned
off (the star rating in the labels then comes from the same numpy code), so
every array must be equal. Map files are compared as arrays, not bytes:
``np.savez`` stamps zip times. The C++ star rating sums in another order
than numpy: within 1e-9 relative.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FIXTURES = sorted((REPO / "tests" / "fixtures").glob("*.osu"))


@pytest.fixture
def numpy_paths(monkeypatch):
    """both packages on their numpy paths (star rating, fitter, WAV)"""
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu_torch import native as tnative

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _parse(fixture: Path):
    """-> (JAX Beatmap, port Beatmap, frame times covering the map + 1 s)"""
    from osu_dreamer_tpu.osu import Beatmap as JBeatmap
    from osu_dreamer_tpu_torch.audio.constants import HOP_LEN, SR, get_frame_times
    from osu_dreamer_tpu_torch.osu import Beatmap as TBeatmap

    text = fixture.read_text()
    jbm, tbm = JBeatmap(text), TBeatmap(text)
    end_ms = max(o.end_time() for o in tbm.hit_objects) + 1000.0
    return jbm, tbm, get_frame_times(int(end_ms / (HOP_LEN / SR * 1000.0)) + 1)


def test_fixtures_present():
    assert len(FIXTURES) == 6


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_signals_and_labels_match_jax(numpy_paths, fixture):
    from osu_dreamer_tpu.signal.cursor import cursor_signal as jcursor
    from osu_dreamer_tpu.signal.encoding import get_labels as jlabels
    from osu_dreamer_tpu.signal.hits import hit_signal as jhit
    from osu_dreamer_tpu.signal.timing import timing_signal as jtiming
    from osu_dreamer_tpu_torch.signal.cursor import cursor_signal
    from osu_dreamer_tpu_torch.signal.encoding import get_labels
    from osu_dreamer_tpu_torch.signal.hits import hit_signal
    from osu_dreamer_tpu_torch.signal.timing import timing_signal

    jbm, tbm, ft = _parse(fixture)
    for name, got, want in (("hit", hit_signal(tbm, ft), jhit(jbm, ft)),
                            ("cursor", cursor_signal(tbm, ft), jcursor(jbm, ft)),
                            ("timing", timing_signal(tbm, ft), jtiming(jbm, ft)),
                            ("labels", get_labels(tbm), jlabels(jbm))):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the fixture exercises the codec: onsets present, the cursor moves
    hit = hit_signal(tbm, ft)
    assert hit[0].max() > 0.99 and np.ptp(cursor_signal(tbm, ft), axis=1).min() > 0.05


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_write_beatmap_reads_back_as_jax(numpy_paths, fixture):
    """each package's map file, read by each package's reader, gives the
    same (signal, labels)"""
    from osu_dreamer_tpu.signal.encoding import read_beatmap as jread
    from osu_dreamer_tpu.signal.encoding import write_beatmap as jwrite
    from osu_dreamer_tpu_torch.signal.encoding import read_beatmap, write_beatmap

    jbm, tbm, ft = _parse(fixture)
    files = {}
    for who, write, bm in (("jax", jwrite, jbm), ("port", write_beatmap, tbm)):
        buf = io.BytesIO()
        write(buf, bm, ft)
        files[who] = buf.getvalue()
    with np.load(io.BytesIO(files["port"])) as npz:
        port_npz = {k: npz[k] for k in npz.files}
    with np.load(io.BytesIO(files["jax"])) as npz:
        assert sorted(npz.files) == sorted(port_npz)
        for k in npz.files:
            assert npz[k].dtype == port_npz[k].dtype, k
            np.testing.assert_array_equal(port_npz[k], npz[k], err_msg=k)
    want_sig, want_labels = jread(io.BytesIO(files["jax"]))
    for read in (read_beatmap, jread):
        sig, labels = read(io.BytesIO(files["port"]))
        np.testing.assert_array_equal(sig, want_sig)
        np.testing.assert_array_equal(labels, want_labels)
    assert sig.shape == (9, len(ft))


def test_nan_is_refused_as_jax(numpy_paths, monkeypatch):
    """a NaN in a signal or the labels raises the JAX package's ValueError"""
    from osu_dreamer_tpu.signal import encoding as jenc
    from osu_dreamer_tpu_torch.signal import encoding as tenc

    jbm, tbm, ft = _parse(FIXTURES[0])
    for enc, bm in ((jenc, jbm), (tenc, tbm)):
        monkeypatch.setattr(enc, "get_labels", lambda bm: np.array([np.nan, 1, 2, 3, 4]))
        with pytest.raises(ValueError, match="labels contains nan"):
            enc.write_beatmap(io.BytesIO(), bm, ft)
        with pytest.raises(ValueError, match="cursor signal contains nan"):
            enc._reject_nan(np.array([[0.0, np.nan]]), "cursor signal")


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda p: p.stem)
def test_native_star_rating_matches_numpy(fixture):
    """the port's C++ star rating (native/osudreamer_native.cpp through its
    own binding) against its numpy fallback"""
    from osu_dreamer_tpu_torch import native
    from osu_dreamer_tpu_torch.osu.difficulty import _star_rating_py, star_rating

    if not native.available():
        pytest.fail("the port's native library did not build (g++ is needed)")
    _, tbm, _ = _parse(fixture)
    want = _star_rating_py(tbm)
    assert want > 0
    assert star_rating(tbm) == pytest.approx(want, rel=1e-9)
