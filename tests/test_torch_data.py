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
