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


@pytest.mark.parametrize("variant,L", [("resident", 300), ("blocked", 600), ("resident", 65),
                                       ("resident", 128), ("resident", 129), ("resident", 759),
                                       ("blocked", 2049)])
def test_attention_plain_matches_pallas(variant, L):
    """both TPU variants in interpret mode (k/v resident, and online softmax
    over 512-wide k-blocks), ragged L, f32 inputs; the lengths straddle the
    CUDA kernel's tile edges (64-key tiles, 192-query blocks), the sampler's
    L = 759 and one past the TPU's resident limit"""
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
    from osu_dreamer_tpu_torch.ops.film_layer import (
        film_layer_bwd_cuda, film_layer_cuda, film_layer_tp_bwd_cuda, film_layer_tp_partial_cuda,
    )
    from osu_dreamer_tpu_torch.ops.film_qkv import film_qkv_bwd_cuda, film_qkv_fwd_cuda
    from osu_dreamer_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_cuda, fused_attention_fwd_cuda,
    )
    from osu_dreamer_tpu_torch.ops.long_attention import attention_cuda
    from osu_dreamer_tpu_torch.ops.resonator import resonate_cuda
    from osu_dreamer_tpu_torch.ops.swiglu import (
        swiglu_bwd_cuda, swiglu_bwd_full_cuda, swiglu_cuda, swiglu_tp_bwd_cuda,
        swiglu_tp_partial_cuda,
    )

    w = [T(a) for a in ffn_weights(16, 20, 3, 0)]
    x = torch.zeros(1, 8, 16, dtype=torch.bfloat16)
    z = torch.zeros(1, 16, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    qkv = torch.zeros(1, 8, 384, dtype=torch.bfloat16)
    g, lse = torch.ones(64), torch.zeros(1, 2, 8)
    o = qkv[..., :128].contiguous()
    xq, zq = torch.zeros(1, 8, 128, dtype=torch.bfloat16), torch.zeros(1, 128)
    wq, bq = torch.zeros(128, 384), torch.zeros(384)
    return {
        "swiglu": lambda: swiglu_cuda(x, *w),
        "film_layer": lambda: film_layer_cuda(x, z, z, z, z[0], z[0], *w),
        "film_layer_bwd": lambda: film_layer_bwd_cuda(x, z, z, z, z[0], z[0], *w, x),
        "flash_attention": lambda: attention_cuda(q, q, q),
        "resonator": lambda: resonate_cuda(torch.zeros(1, 8, 98)),
        "swiglu_bwd": lambda: swiglu_bwd_cuda(x, *w[:5], x),
        "fused_attention_fwd": lambda: fused_attention_fwd_cuda(qkv, g, g, 2),
        "fused_attention_bwd": lambda: fused_attention_bwd_cuda(qkv, o, o, lse, g, g, 2),
        "swiglu_bwd_full": lambda: swiglu_bwd_full_cuda(x, *w[:5], x),
        "film_qkv_fwd": lambda: film_qkv_fwd_cuda(xq, zq, zq, xq, wq, bq),
        "film_qkv_bwd": lambda: film_qkv_bwd_cuda(xq, zq, zq, xq, wq, bq, qkv),
        # the TP forms on a rank's slice of H 40 (2 ranks)
        "swiglu_tp": lambda: swiglu_tp_partial_cuda(x, *w[:5], 40, 2),
        "swiglu_bwd_tp": lambda: swiglu_tp_bwd_cuda(x, *w[:5], x, torch.zeros(8 * 17), 40, 2),
        "film_layer_tp": lambda: film_layer_tp_partial_cuda(x, z, z, z, z[0], z[0], *w[:5], 40, 2),
        "film_layer_bwd_tp": lambda: film_layer_tp_bwd_cuda(
            x, z, z, z, z[0], z[0], *w, x, torch.zeros(8 * 17), x, 40, 2),
    }


@pytest.mark.parametrize("kernel", ["swiglu", "film_layer", "flash_attention", "resonator",
                                    "swiglu_bwd", "fused_attention_fwd", "fused_attention_bwd",
                                    "film_layer_bwd", "swiglu_bwd_full", "film_qkv_fwd",
                                    "film_qkv_bwd", "swiglu_tp", "swiglu_bwd_tp", "film_layer_tp",
                                    "film_layer_bwd_tp"])
def test_cuda_wrapper_refuses_cpu_tensors(kernel):
    """a kernel wrapper never falls back: given a CPU tensor it raises
    before building or launching anything, and counts no launch"""
    from osu_dreamer_tpu_torch.ops import _build

    before = dict(_build.launches)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda_wrappers()[kernel]()
    assert _build.launches == before


def _c_prototypes() -> dict[str, list[str]]:
    """name -> argument kinds ('pointer', 'int', 'float', 'long' for long
    long) of every extern "C" entry point in csrc/*.cu"""
    import re

    from osu_dreamer_tpu_torch.ops import _build

    protos = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            kinds = []
            for arg in args.split(","):
                arg = arg.split()
                kinds.append("pointer" if "*" in "".join(arg) else arg[-2])
            protos[name] = kinds
    return protos


_ENTRY_POINTS = ["odt_resonate", "odt_film_layer_fwd", "odt_swiglu_fwd", "odt_flash_attention_fwd",
                 "odt_swiglu_bwd", "odt_fused_attention_fwd", "odt_fused_attention_bwd",
                 "odt_film_layer_bwd", "odt_swiglu_bwd_full", "odt_film_qkv_fwd",
                 "odt_film_qkv_bwd", "odt_ffn_weight_maps", "odt_swiglu_fwd_tp",
                 "odt_film_layer_fwd_tp", "odt_swiglu_bwd_tp", "odt_film_layer_bwd_tp",
                 "odt_attention_stream_fwd", "odt_fused_attention_stream_fwd",
                 "odt_fused_attention_stream_bwd", "odt_attention_stream_bwd",
                 "odt_swiglu_bwd_full_tp", "odt_film_qkv_bwd_tp", "odt_long_attention_bwd",
                 "odt_qk_prep", "odt_qk_post"]


def test_c_entry_points_are_the_bound_ones():
    from osu_dreamer_tpu_torch.ops import _build

    assert sorted(_c_prototypes()) == sorted(_build._SIGNATURES) == sorted(_ENTRY_POINTS)


@pytest.mark.parametrize("name", _ENTRY_POINTS)
def test_ctypes_signature_matches_c_prototype(name):
    """each ctypes argtypes list names the C prototype's arguments kind for
    kind (a pointer declared as an int would be cut to 32 bits), the stream
    last"""
    import ctypes

    from osu_dreamer_tpu_torch.ops import _build

    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_longlong: "long"}
    proto = _c_prototypes()[name]
    assert [kinds[t] for t in _build._SIGNATURES[name]] == proto
    assert proto[-1] == "pointer"


# ------------------------------------------------------ training kernels ----


def _qkv_inputs(B: int, L: int, H: int, seed: int = 0):
    D = 64
    return (randn(seed, B, L, 3 * H * D, scale=0.7), 1 + randn(seed + 1, D, scale=0.2),
            1 + randn(seed + 2, D, scale=0.2))


def test_fused_attention_gate_matches_jax():
    from osu_dreamer_tpu.ops.fused_attention import MAX_FUSED_LEN
    from osu_dreamer_tpu.ops.fused_attention import fused_attention_fits as jfits
    from osu_dreamer_tpu_torch.ops import fused_attention as tfa

    assert tfa.MAX_FUSED_LEN == MAX_FUSED_LEN
    for L in (1, 152, 256, 257, 512, 513, 759):
        for H, D in ((16, 64), (8, 64), (2, 64), (2, 8), (4, 32), (3, 33)):
            assert tfa.fused_attention_fits(L, H, D) == jfits(L, H, D), (L, H, D)


def test_fused_attention_plain_matches_jax_reference():
    """the plain forward (K9's) and its autograd gradients (K10's) against
    ``rope_attention_reference`` and its ``jax.vjp``, f32, ragged L = 77
    (1e-5: f32 on both sides, products summed in other orders)"""
    from osu_dreamer_tpu.ops.fused_attention import rope_attention_reference
    from osu_dreamer_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_plain, fused_attention_fwd_plain, fused_norm_rope_attention,
    )

    qkv, qg, kg = _qkv_inputs(2, 77, 2)
    go = randn(9, 2, 77, 128)
    want, vjp = jax.vjp(lambda a, b, c: rope_attention_reference(a, b, c, 2), qkv, qg, kg)
    got = fused_norm_rope_attention(T(qkv), T(qg), T(kg), 2)
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5)
    out, lse = fused_attention_fwd_plain(T(qkv), T(qg), T(kg), 2)
    np.testing.assert_array_equal(N(out), N(got))
    assert lse.shape == (2, 2, 77)
    grads = fused_attention_bwd_plain(T(qkv), T(go), out, lse, T(qg), T(kg), 2)
    for name, g, w in zip(("dqkv", "dq_gamma", "dk_gamma"), grads, vjp(go)):
        np.testing.assert_allclose(N(g), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


def test_fused_attention_plain_matches_pallas_interpret():
    """the Pallas forward and backward kernels in interpret mode at a ragged
    length (21: padded to 24 inside the kernel) and the smallest shape that
    keeps tier 1 fast (f32; 1e-4: the kernel forms the rotation and the
    head statistics as matrix products)"""
    from osu_dreamer_tpu.ops.fused_attention import fused_norm_rope_attention as jfused
    from osu_dreamer_tpu_torch.ops.fused_attention import (
        fused_attention_bwd_plain, fused_attention_fwd_plain,
    )

    qkv, qg, kg = _qkv_inputs(1, 21, 2, seed=4)
    go = randn(11, 1, 21, 128)
    want, vjp = jax.vjp(lambda a, b, c: jfused(a, b, c, 2, True), qkv, qg, kg)
    res = fused_attention_fwd_plain(T(qkv), T(qg), T(kg), 2)
    np.testing.assert_allclose(N(res[0]), np.asarray(want), atol=1e-4)
    grads = fused_attention_bwd_plain(T(qkv), T(go), *res, T(qg), T(kg), 2)
    for name, g, w in zip(("dqkv", "dq_gamma", "dk_gamma"), grads, vjp(go)):
        np.testing.assert_allclose(N(g), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=name)


SWIGLU_GRADS = ("dx", "d_dw_kernel", "d_dw_bias", "d_vg_kernel", "d_vg_bias", "d_out_kernel",
                "d_out_bias")


@pytest.mark.parametrize("B,L,C,H,K", [(2, 70, 16, 20, 5), (1, 33, 8, 13, 3)])
def test_swiglu_bwd_plain_matches_jax_vjp(B, L, C, H, K):
    """``swiglu_bwd_plain`` (K6's plain version) against ``jax.vjp`` of
    ``swiglu_reference``: every gradient, f32, ragged L and odd H (1e-5)"""
    from osu_dreamer_tpu.ops.swiglu import swiglu_reference
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu_bwd_plain

    x, w, go = randn(0, B, L, C), ffn_weights(C, H, K, 1), randn(9, B, L, C)
    _, vjp = jax.vjp(swiglu_reference, x, *w)
    got = swiglu_bwd_plain(T(x), *map(T, w[:5]), T(go))
    for name, g, want in zip(SWIGLU_GRADS, got, vjp(go)):
        np.testing.assert_allclose(N(g), np.asarray(want), atol=1e-5, rtol=1e-5, err_msg=name)


def test_swiglu_bwd_plain_matches_pallas_partial_interpret():
    """the JAX partial backward kernel (the one K6 replaces) in interpret
    mode at the smallest shape of its own test (f32; 2e-4 as there: the
    kernel keeps its recomputed forward in f32)"""
    from osu_dreamer_tpu.ops.swiglu import _fused_swiglu_partial_bwd_impl
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu_bwd_plain

    B, L, C, H, K = 1, 33, 8, 13, 3
    x, w, go = randn(2, B, L, C), ffn_weights(C, H, K, 3), randn(4, B, L, C)
    want = _fused_swiglu_partial_bwd_impl(
        *map(jnp.asarray, (x, *w[:5], go)), tile=16, interpret=True
    )
    got = swiglu_bwd_plain(T(x), *map(T, w[:5]), T(go))
    for name, g, ref in zip(SWIGLU_GRADS, got, want):
        np.testing.assert_allclose(N(g), np.asarray(ref), atol=2e-4, rtol=2e-4, err_msg=name)


def test_autograd_functions_route_through_their_kernels(monkeypatch):
    """the three autograd Functions the CUDA path takes, wired on the CPU with
    their kernels' plain stand-ins: each forward and backward goes through
    the stand-in, and the gradients equal autograd of the plain version"""
    from osu_dreamer_tpu_torch.ops import film_layer as fl
    from osu_dreamer_tpu_torch.ops import fused_attention as fa
    from osu_dreamer_tpu_torch.ops import swiglu as sw

    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(sw, "swiglu_cuda", spy("swiglu", sw.swiglu_plain))
    monkeypatch.setattr(sw, "swiglu_bwd_cuda", spy("swiglu_bwd", sw.swiglu_bwd_plain))
    monkeypatch.setattr(sw, "swiglu_bwd_full_cuda", spy("swiglu_bwd_full", sw.swiglu_bwd_plain))
    monkeypatch.setattr(fa, "fused_attention_fwd_cuda", spy("fwd", fa.fused_attention_fwd_plain))
    monkeypatch.setattr(fa, "fused_attention_bwd_cuda", spy("bwd", fa.fused_attention_bwd_plain))
    monkeypatch.setattr(fl, "film_layer_cuda", spy("film_layer", fl.film_layer_plain))
    monkeypatch.setattr(fl, "film_layer_bwd_cuda", spy("film_layer_bwd", fl.film_layer_bwd_plain))

    # C 64: a width every kernel of the route takes (K4, K5, K2, K3)
    x, w = randn(0, 2, 19, 64), ffn_weights(64, 42, 5, 1)
    qkv, qg, kg = _qkv_inputs(2, 19, 2)
    cases = [
        (sw.SwiGLUFunction.apply, sw.swiglu_plain, [T(x), *map(T, w)], ()),
        (fa.FusedNormRopeAttention.apply, fa.rope_attention_plain, [T(qkv), T(qg), T(kg)], (2,)),
        (fl.FilmLayerFunction.apply, fl.film_layer_plain,
         [T(a) for a in _film_inputs(19, 2, C=64, H=42)], ()),
    ]
    for fn, plain, leaves, extra in cases:
        leaves = [t.requires_grad_() for t in leaves]
        got = torch.autograd.grad(fn(*leaves, *extra).square().sum(), leaves)
        want = torch.autograd.grad(plain(*leaves, *extra).square().sum(), leaves)
        for g, r in zip(got, want):
            np.testing.assert_allclose(N(g), N(r), atol=1e-5, rtol=1e-5)
    # at these dims the JAX dispatch takes its full SwiGLU backward, so K5 runs
    assert calls == ["swiglu", "swiglu_bwd_full", "fwd", "bwd", "film_layer", "film_layer_bwd"]


class _CudaLooking(torch.Tensor):
    """a CPU tensor that reports ``is_cuda``, to follow the dispatch on a
    machine without a card"""

    @property
    def is_cuda(self):
        return True


def test_film_layer_on_cuda_tensor_builds_graph_through_kernels(monkeypatch):
    """``film_layer`` sends a CUDA tensor through ``FilmLayerFunction`` (K2
    forward, K3 backward): the output carries that Function's graph node, so
    every parameter and FiLM vector gets its gradient (before, the kernel's
    output had no graph at all)"""
    from osu_dreamer_tpu_torch.ops import film_layer as fl

    monkeypatch.setattr(fl, "film_layer_cuda", fl.film_layer_plain)
    monkeypatch.setattr(fl, "film_layer_bwd_cuda", fl.film_layer_bwd_plain)
    leaves = [T(a).requires_grad_() for a in _film_inputs(19, 2, C=64, H=42)]
    out = fl.film_layer(leaves[0].as_subclass(_CudaLooking), *leaves[1:])
    assert type(out.grad_fn).__name__ == "FilmLayerFunctionBackward"
    grads = torch.autograd.grad(out.square().sum(), leaves)
    want = torch.autograd.grad(fl.film_layer_plain(*leaves).square().sum(), leaves)
    for g, r in zip(grads, want):
        np.testing.assert_allclose(N(g), N(r), atol=1e-5, rtol=1e-5)


def _film_inputs(L: int, B: int, C: int = 16, H: int = 20, K: int = 5, seed: int = 0):
    """x, scale, shift, gate, g1, g2 and the SwiGLU weights of one film layer"""
    return [randn(seed, B, L, C), randn(seed + 1, B, C, scale=0.5),
            randn(seed + 2, B, C, scale=0.5), randn(seed + 3, B, C, scale=0.5),
            1 + randn(seed + 4, C, scale=0.1), 1 + randn(seed + 5, C, scale=0.1),
            *ffn_weights(C, H, K, seed + 6)]


FILM_GRADS = ("dx", "dscale", "dshift", "dgate", "dg1", "dg2", "d_dw_kernel", "d_dw_bias",
              "d_vg_kernel", "d_vg_bias", "d_out_kernel", "d_out_bias")


@pytest.mark.parametrize("B,L,C,H,K", [(2, 70, 16, 20, 5), (1, 33, 8, 12, 3)])
def test_film_layer_bwd_plain_matches_jax_vjp(B, L, C, H, K):
    """``film_layer_bwd_plain`` (K3's plain version) against ``jax.vjp`` of
    ``film_layer_reference``: all twelve gradients, f32, nonzero FiLM, ragged
    L (1e-5 relative plus 1e-6 of the gradient's largest magnitude: f32 on
    both sides, the parameter gradients summed over B*L rows in other
    orders)"""
    from osu_dreamer_tpu.ops.film_layer import film_layer_reference
    from osu_dreamer_tpu_torch.ops.film_layer import film_layer_bwd_plain

    args, go = _film_inputs(L, B, C, H, K), randn(9, B, L, C)
    _, vjp = jax.vjp(film_layer_reference, *args)
    got = film_layer_bwd_plain(*map(T, args), T(go))
    for name, g, want in zip(FILM_GRADS, got, vjp(go)):
        want = np.asarray(want)
        np.testing.assert_allclose(N(g), want, atol=1e-6 * np.abs(want).max(), rtol=1e-5,
                                   err_msg=name)


def test_film_layer_bwd_plain_matches_pallas_interpret():
    """the Pallas backward kernel K3 replaces, in interpret mode at the
    smallest case above with 16-row tiles (three tiles, the last ragged;
    f32; 2e-4: the kernel forms its row means as ones-matmuls and keeps its
    recompute in f32)"""
    from osu_dreamer_tpu.ops.film_layer import _fused_film_layer_bwd_impl
    from osu_dreamer_tpu_torch.ops.film_layer import film_layer_bwd_plain

    B, L, C, H, K = 1, 33, 8, 12, 3
    args, go = _film_inputs(L, B, C, H, K, seed=3), randn(4, B, L, C)
    want = _fused_film_layer_bwd_impl(*map(jnp.asarray, args), jnp.asarray(go), tile=16,
                                      interpret=True)
    got = film_layer_bwd_plain(*map(T, args), T(go))
    for name, g, ref in zip(FILM_GRADS, got, want):
        np.testing.assert_allclose(N(g), np.asarray(ref), atol=2e-4, rtol=2e-4, err_msg=name)
