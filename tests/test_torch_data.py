"""The port's cached-latent pipeline (osu_dreamer_tpu_torch/data/pipeline.py)
against the JAX package's on a seeded temporary corpus: both are numpy and
``random.Random``, so the same seed must give the same arrays in the same
order, exactly."""

from __future__ import annotations

import random

import numpy as np
import pytest

from osu_dreamer_tpu.data import pipeline as jp
from osu_dreamer_tpu_torch.data import pipeline as tp
from osu_dreamer_tpu_torch.data.synth import write_latent_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("latents")
    write_latent_corpus(root, 5, 3, 70, 8, 4, 6, seed=3)
    # one mapset with maps of other lengths: h longer than z, a map shorter
    # than a window
    d = root / "set_odd"
    d.mkdir()
    np.save(d / "h.npy", np.ones((90, 8), np.float32))
    for i, n in enumerate((80, 10)):
        np.savez(d / f"{i}.latent.npz", z=np.full((n, 4), i, np.float32),
                 s=np.zeros(6, np.float32), labels=np.zeros(5, np.float32))
    return root


def _same(a, b) -> None:
    a, b = list(a), list(b)
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("count,frac", [(128, 0.3), (1, 0.5), (0, 0.3)])
def test_hold_out_mapsets_matches_jax(corpus, count, frac):
    assert tp.hold_out_mapsets(corpus, "*.latent.npz", count, frac) == \
        jp.hold_out_mapsets(corpus, "*.latent.npz", count, frac)


@pytest.mark.parametrize("seq_len,buffer,cap,seed,shard", [
    (16, 8, -1, 0, None), (16, 1, 1, 5, None), (24, 512, 2, 7, None), (16, 4, -1, 1, (2, 1)),
])
def test_latent_windows_match_jax(corpus, seq_len, buffer, cap, seed, shard):
    sets, _ = jp.hold_out_mapsets(corpus, "*.latent.npz", 0, 0.0)
    kw = dict(shuffle_buffer=buffer, max_per_map=cap, seed=seed, shard=shard)
    _same(tp.latent_windows(sets, seq_len, **kw), jp.latent_windows(sets, seq_len, **kw))
    assert tp.count_latent_windows(sets, seq_len, cap, shard) == \
        jp.count_latent_windows(sets, seq_len, cap, shard)


def test_full_maps_and_batches_match_jax(corpus):
    """``seq_len=None`` (validation) streams, and drop-last batches through
    the prefetch thread"""
    sets, _ = jp.hold_out_mapsets(corpus, "*.latent.npz", 0, 0.0)
    _same(tp.latent_windows(sets, None), jp.latent_windows(sets, None))
    assert tp.count_latent_windows(sets, None) == jp.count_latent_windows(sets, None)
    kw = dict(shuffle_buffer=8, max_per_map=-1, seed=2)
    _same(tp.prefetch(tp.batched(tp.latent_windows(sets, 16, **kw), 3)),
          jp.batched(jp.latent_windows(sets, 16, **kw), 3))


def test_window_helpers_match_jax():
    for length, window, cap, seed in [(70, 16, -1, 0), (70, 16, 2, 1), (10, 16, -1, 2),
                                      (64, 16, 0, 3)]:
        a = tp._window_starts(length, window, cap, random.Random(seed))
        assert a == jp._window_starts(length, window, cap, random.Random(seed))
    items = list(range(50))
    assert list(tp._shuffle_buffered(iter(items), 7, random.Random(4))) == \
        list(jp._shuffle_buffered(iter(items), 7, random.Random(4)))


# ------------------------------------------------------ chart-signal data ----


@pytest.fixture(scope="module")
def signal_corpus(tmp_path_factory):
    from osu_dreamer_tpu_torch.data.synth import write_signal_corpus

    root = tmp_path_factory.mktemp("signals")
    write_signal_corpus(root, 5, 3, 90, seed=4)
    # a mapset whose spectrogram is longer than one map and shorter than
    # another, and a map shorter than a window
    d = root / "set_odd"
    d.mkdir()
    rng = np.random.default_rng(1)
    np.save(d / "spec.npy", rng.integers(0, 256, (72, 80), dtype=np.uint8))
    for i, n in enumerate((100, 20)):
        with open(d / f"{i}.map.npy", "wb") as f:
            np.savez(f, hit=rng.integers(0, 256, (7, n), dtype=np.uint8),
                     xy=rng.integers(0, 65536, (2, n), dtype=np.uint16),
                     xy_min=rng.normal(size=(2, 1)), xy_rng=rng.uniform(1, 2, (2, 1)),
                     labels=rng.uniform(0, 10, 5))
    return root


def test_signal_readers_match_jax(signal_corpus):
    """the copies of read_beatmap and read_spec, exactly; the synthetic
    corpus is in write_beatmap's format (keys, dtypes, shapes)"""
    from osu_dreamer_tpu.audio.io import read_spec as jread_spec
    from osu_dreamer_tpu.signal.encoding import Channel as JChannel
    from osu_dreamer_tpu.signal.encoding import read_beatmap as jread
    from osu_dreamer_tpu_torch.audio.io import read_spec
    from osu_dreamer_tpu_torch.signal.encoding import Channel, read_beatmap

    assert {c.name: int(c) for c in Channel} == {c.name: int(c) for c in JChannel}
    for f in sorted(signal_corpus.rglob("*.map.npy")):
        with open(f, "rb") as a, open(f, "rb") as b:
            (got, glab), (want, wlab) = read_beatmap(a), jread(b)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(glab, wlab)
        with np.load(f) as npz:
            L = npz["hit"].shape[1]
            assert npz["hit"].dtype == np.uint8 and npz["hit"].shape == (7, L)
            assert npz["xy"].dtype == np.uint16 and npz["xy"].shape == (2, L)
            assert npz["xy_min"].shape == npz["xy_rng"].shape == (2, 1)
            assert npz["labels"].shape == (5,)
    for f in sorted(signal_corpus.rglob("spec.npy")):
        with open(f, "rb") as a, open(f, "rb") as b:
            got, want = read_spec(a), jread_spec(b)
        assert got.dtype == want.dtype == np.float32 and got.shape[0] == 72
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seq_len,buffer,cap,seed,shard", [
    (18, 8, -1, 0, None), (18, 1, 1, 5, None), (36, 512, 2, 7, None), (18, 4, -1, 1, (2, 1)),
])
def test_signal_windows_match_jax(signal_corpus, seq_len, buffer, cap, seed, shard):
    """the same windows in the same order (flips included) for the same seed"""
    sets, _ = jp.hold_out_mapsets(signal_corpus, "*.map.npy", 0, 0.0)
    kw = dict(shuffle_buffer=buffer, max_per_map=cap, seed=seed, shard=shard)
    _same(tp.signal_windows(sets, seq_len, **kw), jp.signal_windows(sets, seq_len, **kw))
    assert tp.count_signal_windows(sets, seq_len, cap, shard) == \
        jp.count_signal_windows(sets, seq_len, cap, shard)


def test_signal_full_maps_flips_and_padding_match_jax(signal_corpus):
    """validation streams (full maps, no flips), the flip draws on their own,
    and edge padding"""
    sets, _ = jp.hold_out_mapsets(signal_corpus, "*.map.npy", 0, 0.0)
    _same(tp.signal_windows(sets, None, flip_augment=False),
          jp.signal_windows(sets, None, flip_augment=False))
    chart = np.random.default_rng(2).random((20, 9)).astype(np.float32)
    for seed in range(8):
        np.testing.assert_array_equal(tp._flip_xy(chart, random.Random(seed)),
                                      jp._flip_xy(chart, random.Random(seed)))
    for n, m in ((20, 9), (27, 9), (1, 54)):
        np.testing.assert_array_equal(tp.pad_to_multiple(chart[:n], m),
                                      jp.pad_to_multiple(chart[:n], m))
