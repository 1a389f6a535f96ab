"""The port's kernel-holding ops: each plain PyTorch version against the JAX
op on the CPU (the CUDA kernels against the plain versions on the card are in
test_torch_kernels_gpu.py).

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas kernels in interpret mode, the references as plain jnp. CPU
comparisons are f32; tolerances leave room for the summation order of the
matrix products (1e-6 relative) and, for the resonator, for the f32 rounding
of a recurrence over hundreds of frames (the JAX package's own test holds
its kernel to the exact IIR at 5e-3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import N, T, randn

torch.set_num_threads(1)


def ffn_weights(C: int, H: int, K: int, seed: int) -> list[np.ndarray]:
    return [randn(seed, K, C, scale=0.4), randn(seed + 1, C, scale=0.1),
            randn(seed + 2, C, 2 * H, scale=C**-0.5), randn(seed + 3, 2 * H, scale=0.1),
            randn(seed + 4, H, C, scale=H**-0.5), randn(seed + 5, C, scale=0.1)]


@pytest.mark.parametrize("L,K", [(37, 5), (16, 3)])
def test_swiglu_plain_matches_jax(L, K):
    from osu_dreamer_tpu.ops.swiglu import swiglu_reference
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu

    x, w = randn(0, 2, L, 16), ffn_weights(16, 20, K, 1)
    got = swiglu(T(x), *map(T, w))
    np.testing.assert_allclose(N(got), np.asarray(swiglu_reference(x, *w)), atol=1e-5)


def test_film_layer_plain_matches_jax():
    """nonzero FiLM and a ragged length (the Pallas kernel masks the conv
    halo AFTER the FiLM shift; the reference pads with zeros)"""
    from osu_dreamer_tpu.ops.film_layer import _fused_film_layer_fwd_impl, film_layer_reference
    from osu_dreamer_tpu_torch.ops.film_layer import film_layer

    B, L, C = 3, 37, 16
    args = [randn(0, B, L, C), randn(1, B, C, scale=0.5), randn(2, B, C, scale=0.5),
            randn(3, B, C, scale=0.5), 1 + randn(4, C, scale=0.1), 1 + randn(5, C, scale=0.1),
            *ffn_weights(C, 20, 5, 6)]
    got = N(film_layer(*map(T, args)))
    np.testing.assert_allclose(got, np.asarray(film_layer_reference(*args)), atol=1e-5)
    pallas = _fused_film_layer_fwd_impl(*map(jnp.asarray, args), tile=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-4)


@pytest.mark.parametrize("variant,L", [("resident", 300), ("blocked", 600)])
def test_attention_plain_matches_pallas(variant, L):
    """both TPU variants in interpret mode (k/v resident, and online softmax
    over 512-wide k-blocks), ragged L, f32 inputs"""
    from osu_dreamer_tpu.ops.long_attention import _blocked_impl, _fwd_impl
    from osu_dreamer_tpu_torch.ops.long_attention import long_flash_attention

    q, k, v = (randn(i, 1, L, 2, 64, scale=0.7) for i in range(3))
    impl = _fwd_impl if variant == "resident" else _blocked_impl
    want = np.asarray(impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True))
    got = long_flash_attention(T(q), T(k), T(v))
    assert got.shape == (1, L, 128)
    np.testing.assert_allclose(N(got), want, atol=1e-5)


def test_resonator_plain_matches_pallas_and_exact_iir():
    """S=2 songs in one batch: each equals the Pallas kernel (interpret) and
    the exact sequential IIR on its own, so no state leaks between songs;
    the length spans a Pallas tile boundary and several port chunks"""
    from osu_dreamer_tpu.audio.constants import HOP_LEN, N_BINS, SR
    from osu_dreamer_tpu.audio.spectrogram import resonate_reference
    from osu_dreamer_tpu.ops.resonator import TILE, resonate_frames_pallas
    from osu_dreamer_tpu_torch.ops.resonator import resonate_frames

    K = TILE + 37
    waves = np.stack([randn(0, K * HOP_LEN, scale=0.5), 3.0 * randn(1, K * HOP_LEN)])
    got = N(resonate_frames(T(waves.reshape(2, K, HOP_LEN))))
    assert got.shape == (2, K, N_BINS, 2)
    for s in range(2):
        pallas = resonate_frames_pallas(
            jnp.asarray(waves[s].reshape(K, HOP_LEN)), HOP_LEN, N_BINS, SR, interpret=True
        )
        np.testing.assert_allclose(got[s], np.asarray(pallas), atol=1e-4)
        exact = resonate_reference(waves[s])
        np.testing.assert_allclose(got[s, ..., 0], exact.real, atol=5e-3)
        np.testing.assert_allclose(got[s, ..., 1], exact.imag, atol=5e-3)


def test_spec_for_model_batch_matches_jax():
    """two songs of different lengths: per-song masked peak and edge
    replication (f32 log-power normalisation to [0, 1]; 1e-5)"""
    from osu_dreamer_tpu.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu.audio.spectrogram import spec_for_model_batch as jspec
    from osu_dreamer_tpu_torch.audio.spectrogram import spec_for_model_batch as tspec

    preps = [prep_wave_for_model(randn(s, n, scale=0.2), 27)
             for s, n in ((0, 40000), (1, 90000))]
    waves = np.stack([p[0] for p in preps])
    real = np.array([p[1] for p in preps])
    n_frames, out_frames = preps[0][2], preps[0][3]
    want = jspec(jnp.asarray(waves), jnp.asarray(real), n_frames, out_frames, pallas=False)
    got = tspec(torch.from_numpy(waves), torch.from_numpy(real), n_frames, out_frames)
    assert got.shape == (2, out_frames, 72)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5)


def _cuda_wrappers():
    from osu_dreamer_tpu_torch.ops.film_layer import film_layer_cuda
    from osu_dreamer_tpu_torch.ops.long_attention import attention_cuda
    from osu_dreamer_tpu_torch.ops.resonator import resonate_cuda
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu_cuda

    w = [T(a) for a in ffn_weights(16, 20, 3, 0)]
    x = torch.zeros(1, 8, 16, dtype=torch.bfloat16)
    z = torch.zeros(1, 16, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    return {
        "swiglu": lambda: swiglu_cuda(x, *w),
        "film_layer": lambda: film_layer_cuda(x, z, z, z, z[0], z[0], *w),
        "flash_attention": lambda: attention_cuda(q, q, q),
        "resonator": lambda: resonate_cuda(torch.zeros(1, 8, 98)),
    }


@pytest.mark.parametrize("kernel", ["swiglu", "film_layer", "flash_attention", "resonator"])
def test_cuda_wrapper_refuses_cpu_tensors(kernel):
    """a kernel wrapper never falls back: given a CPU tensor it raises
    before building or launching anything, and counts no launch"""
    from osu_dreamer_tpu_torch.ops import _build

    before = dict(_build.launches)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda_wrappers()[kernel]()
    assert _build.launches == before
