"""The traffic and the weights are a function of the seed alone."""

from __future__ import annotations

import math

import numpy as np
import torch
from conftest import ROOT

from portbench import traffic
from portbench.bench import benchmark, resolve
from portbench.weights import draw_state

BENCH = benchmark(ROOT)


def _predict_wl():
    wl = resolve(BENCH, "predict.mapset-120s").wl
    return dict(wl, songs=3, song_seconds=1.5)


def test_songs_and_labels_repeat_by_seed():
    wl = _predict_wl()
    a = traffic.songs(wl, 2**31 + 7, 0, 27, "cpu")
    b = traffic.songs(wl, 2**31 + 7, 0, 27, "cpu")
    c = traffic.songs(wl, 2**31 + 8, 0, 27, "cpu")
    d = traffic.songs(wl, 2**31 + 7, 1, 27, "cpu")
    assert torch.equal(a["waves"], b["waves"]) and not torch.equal(a["waves"], c["waves"])
    assert not torch.equal(a["waves"], d["waves"])
    assert a["waves"].dtype == torch.int16 and a["waves"].shape[1] % (98 * 1024) == 0
    assert a["out_frames"] % 27 == 0 and a["n_frames"] * 98 == a["waves"].shape[1]
    assert a["real_frames"].tolist() == [math.ceil(1.5 * 16384 / 98)] * 3
    la = traffic.labels(wl, 5, 0, "cpu")
    assert torch.equal(la, traffic.labels(wl, 5, 0, "cpu"))
    assert la.shape == (3, wl["difficulties"], 5)
    assert bool((la[:, -1, 0] > la[:, 0, 0]).all())  # star rating rises from Easy to Expert


def test_latents_and_noise_repeat_by_seed():
    cell = resolve(BENCH, "train.denoiser-l152")
    wl = dict(cell.wl, batch=4, seq_len=8, pool=3)
    a = traffic.latent_batches(cell.cfg, wl, 11, "cpu")
    b = traffic.latent_batches(cell.cfg, wl, 11, "cpu")
    c = traffic.latent_batches(cell.cfg, wl, 12, "cpu")
    assert len(a) == 3 and all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][1], c[0][1]) and not torch.equal(a[0][1], a[1][1])
    t1, x1 = traffic.train_noise(cell.cfg, 4, 8, 11, 0, "cpu")
    t2, x2 = traffic.train_noise(cell.cfg, 4, 8, 11, 0, "cpu")
    assert torch.equal(t1, t2) and torch.equal(x1, x2) and bool(((t1 > 0) & (t1 < 1)).all())
    s1, z1 = traffic.sampler_noise(resolve(BENCH, "predict.mapset-120s").cfg, 4, 8, 11, 3, "cpu")
    s2, z2 = traffic.sampler_noise(resolve(BENCH, "predict.mapset-120s").cfg, 4, 8, 11, 3, "cpu")
    assert torch.equal(s1, s2) and torch.equal(z1, z2)


def test_weights_repeat_by_seed_and_are_damped():
    shapes = {"a.film0.kernel": (8, 24), "a.proj.kernel": (8, 4), "a.norm.gamma": (4,),
              "a.proj.bias": (4,)}
    damped = {"scale": 0.1, "names": ["film"]}
    w1 = draw_state(shapes, 2**31 + 3, "cpu", damped)
    w2 = draw_state(shapes, 2**31 + 3, "cpu", damped)
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    big = draw_state({"a.proj.kernel": (4096, 64)}, 1, "cpu")["a.proj.kernel"]
    assert abs(float(big.std()) - 4096 ** -0.5) < 0.05 * 4096 ** -0.5
    assert float(w1["a.film0.kernel"].abs().max()) < 0.1 * 6 / 8 ** 0.5
    assert bool((w1["a.norm.gamma"] > 0.5).all()) and bool((w1["a.proj.bias"] != 0).all())


def test_seed_streams_are_63_bit():
    s = {traffic.seed_of(2**31 + 1, stream, i) for stream in ("weights", "songs") for i in (0, 1)}
    assert len(s) == 4 and all(0 <= x < 2**63 for x in s)
    assert traffic.seed_of(-5, "noise") == traffic.seed_of(2**64 - 5, "noise")
    assert np.isscalar(traffic.seed_of(0, "pick"))
