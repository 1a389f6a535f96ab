"""The port's inference slice as a whole against the JAX package on the CPU:
int16 waves -> spec_for_model_batch -> LDM (style prior, denoiser, decoder)
-> quantized chart, tiny model, f32, with every weight random (fill_tree) and
the samplers' noise drawn as the JAX LDM draws it.

Tolerance: the float chart and labels agree to 1e-3 after 16 style steps and
3 denoiser steps (each step feeds the last step's f32 rounding differences
back in). The quantized chart may differ by one step where a value lies
within that error of a rounding boundary (k + 0.5 on the uint8/int16 grid),
so (hit_u8, xy_i16) are held to +-1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import KEY, N, T, fill_tree, port, randn, tiny_args

torch.set_num_threads(1)

LABELS = np.array([[5, 9, 8, 4, 6], [3, 5, 5, 4, 4]], np.float32)


@pytest.mark.parametrize("case", ["shared_labels", "per_song_labels", "one_song"])
def test_slice_matches_jax(case):
    from osu_dreamer_tpu.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu.audio.spectrogram import spec_for_model_batch as jspec
    from osu_dreamer_tpu.models.inference.model import LDM as JLDM
    from osu_dreamer_tpu.models.inference.sampler import build_batch_sampler as jbuild
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent
    from osu_dreamer_tpu_torch.audio.spectrogram import spec_for_model_batch as tspec
    from osu_dreamer_tpu_torch.models.inference.model import LDM as TLDM
    from osu_dreamer_tpu_torch.models.inference.sampler import build_batch_sampler as tbuild

    ja, ta = tiny_args("jax"), tiny_args("torch")
    chunk = ja.latent.chunk_size
    lengths = (40000,) if case == "one_song" else (40000, 90000)
    preps = [prep_wave_for_model(randn(i, n, scale=0.3), chunk) for i, n in enumerate(lengths)]
    waves = np.stack([p[0] for p in preps])
    real = np.array([p[1] for p in preps], np.int32)
    n_frames, out_frames = preps[0][2], preps[0][3]
    S, D = len(lengths), len(LABELS)
    labels = np.stack([LABELS, LABELS[::-1]]) if case == "per_song_labels" else LABELS
    steps, guidance = 3, 2.0

    jm = JLDM(ja, jnp.float32)
    # the whole tree as export-inference writes it: the latent model's chart
    # encoder, which the port's LDM holds too, included
    tree = jm.init(KEY, jnp.zeros((1, out_frames, 72)), LABELS, KEY, 1, 1)
    latent = JLatent(ja.latent, jnp.float32).init(
        KEY, jnp.zeros((1, out_frames, 72)), jnp.zeros((1, out_frames, 9)),
        method=JLatent.init_all)
    tree = fill_tree({"params": {**tree["params"], "latent": latent["params"]}}, 21)
    key = jax.random.PRNGKey(5)
    rng_style, rng_z = jax.random.split(key)
    s0 = np.asarray(jax.random.normal(rng_style, (S * D, ja.style.style_dim), jnp.float32))
    x0 = np.asarray(jax.random.normal(
        rng_z, (S * D, out_frames // chunk, ja.diffusion.emb_dim), jnp.float32))

    spec_j = jspec(jnp.asarray(waves), jnp.asarray(real), n_frames, out_frames, pallas=False)
    chart_j, lab_j = jax.jit(
        lambda p, sp, lb, k: jm.apply(p, sp, lb, k, steps, style_guidance=guidance)
    )(tree, spec_j, labels, key)
    hit_j, xy_j, qlab_j = jbuild(jm)(tree, waves, real, labels, key, n_frames, out_frames,
                                     steps, guidance)

    tm = port(TLDM(ta, torch.float32), tree)
    waves_t, real_t, labels_t = torch.from_numpy(waves), torch.from_numpy(real), T(labels)
    with torch.inference_mode():
        spec_t = tspec(waves_t, real_t, n_frames, out_frames)
        chart_t, lab_t = tm(spec_t, labels_t, steps, style_guidance=guidance,
                            s0=T(s0), x0=T(x0))
    hit_t, xy_t, qlab_t = tbuild(tm)(waves_t, real_t, labels_t, None, n_frames, out_frames,
                                     steps, guidance, s0=T(s0), x0=T(x0))

    assert chart_t.shape == (S * D, out_frames, 9) and lab_t.shape == (S * D, 5)
    np.testing.assert_allclose(N(spec_t), np.asarray(spec_j), atol=1e-5)
    np.testing.assert_allclose(N(chart_t), np.asarray(chart_j), atol=1e-3)
    np.testing.assert_allclose(N(lab_t), np.asarray(lab_j), atol=1e-3)
    assert hit_t.dtype == torch.uint8 and xy_t.dtype == torch.int16
    assert np.abs(hit_t.numpy().astype(int) - np.asarray(hit_j, int)).max() <= 1
    assert np.abs(xy_t.numpy().astype(int) - np.asarray(xy_j, int)).max() <= 1
    np.testing.assert_allclose(N(qlab_t), np.asarray(qlab_j), atol=1e-3)


def test_quantize_roundtrip_matches_jax():
    """the quantized transfer format: the port's quantize_chart matches the
    JAX sampler's grid (f32), and dequantize_chart equals the JAX one and
    returns each value to within half a quantization step"""
    from osu_dreamer_tpu.models.inference.sampler import dequantize_chart as jdeq
    from osu_dreamer_tpu_torch.models.inference.sampler import dequantize_chart, quantize_chart

    rng = np.random.default_rng(3)
    chart = np.concatenate([rng.uniform(-0.2, 1.2, (2, 50, 7)), rng.uniform(-5, 5, (2, 50, 2))],
                           axis=-1).astype(np.float32)
    hit, xy = quantize_chart(T(chart))
    np.testing.assert_array_equal(
        hit.numpy(), np.round(np.clip(chart[..., :7], 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(
        xy.numpy(), np.round(np.clip(chart[..., 7:], -4, 4) * 8191).astype(np.int16))
    back = dequantize_chart(hit.numpy(), xy.numpy())
    np.testing.assert_array_equal(back, jdeq(hit.numpy(), xy.numpy()))
    clipped = np.concatenate([np.clip(chart[..., :7], 0, 1), np.clip(chart[..., 7:], -4, 4)], -1)
    assert np.abs(back[..., :7] - clipped[..., :7]).max() <= 0.5 / 255 + 1e-6
    assert np.abs(back[..., 7:] - clipped[..., 7:]).max() <= 0.5 / 8191 + 1e-6
