"""The fused norm + FiLM + qkv prologue (K11/K12) and the full SwiGLU
backward (K5) in the port against the JAX package on the CPU, in f32.

The JAX side runs as its own tests run it (tests/test_ops.py): the Pallas
kernels in interpret mode, the references as plain jnp. Tolerances: 2e-5 for
the forward (f32 on both sides, the product summed in another order), and
for the gradients the JAX package's own bounds for its kernels against their
references (3e-4 for the prologue, 2e-4 for the SwiGLU backward: those
kernels keep their recompute in f32 and sum over rows in tile order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import KEY, N, T, fill_tree, port, randn
from test_torch_ops import SWIGLU_GRADS, ffn_weights

torch.set_num_threads(1)
F32 = jnp.float32
PROLOGUE_GRADS = ("dx", "dscale", "dshift", "dadd", "dkernel", "dbias")


def _prologue_args(B: int, L: int, C: int, F: int, seed: int = 0) -> list[np.ndarray]:
    """x, scale, shift, add, kernel, bias at the scales of tests/test_ops.py"""
    return [randn(seed, B, L, C), randn(seed + 1, B, C, scale=0.3),
            randn(seed + 2, B, C, scale=0.3), randn(seed + 3, B, L, C, scale=0.5),
            randn(seed + 4, C, F, scale=0.2), randn(seed + 5, F, scale=0.1)]


@pytest.mark.parametrize("B,L,C,F", [(2, 64, 16, 24), (3, 33, 8, 16)])
def test_film_qkv_plain_matches_jax_reference(B, L, C, F):
    from osu_dreamer_tpu.ops.film_qkv import film_qkv_reference
    from osu_dreamer_tpu_torch.ops.film_qkv import film_qkv

    args = _prologue_args(B, L, C, F)
    got = film_qkv(*map(T, args))
    assert got.shape == (B, L, F)
    np.testing.assert_allclose(N(got), np.asarray(film_qkv_reference(*args)), atol=2e-5)


def test_film_qkv_plain_matches_pallas_forward_interpret():
    """the Pallas forward K11 replaces, 16-row tiles over a ragged 33 rows
    (the zero-pad and crop path)"""
    from osu_dreamer_tpu.ops.film_qkv import _fwd_impl
    from osu_dreamer_tpu_torch.ops.film_qkv import film_qkv_plain

    args = _prologue_args(3, 33, 8, 16, seed=6)
    want = _fwd_impl(*map(jnp.asarray, args), tile=16, interpret=True)
    np.testing.assert_allclose(N(film_qkv_plain(*map(T, args))), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("B,L,C,F,tile", [(2, 64, 16, 24, 32), (3, 33, 8, 16, 16)])
def test_film_qkv_bwd_plain_matches_pallas_vjp(B, L, C, F, tile):
    """``film_qkv_bwd_plain`` (K12's plain version) against ``jax.vjp`` of
    the JAX ``film_qkv`` with its Pallas forward and backward in interpret
    mode, the cases of tests/test_ops.py: all six gradients"""
    from osu_dreamer_tpu.ops.film_qkv import film_qkv
    from osu_dreamer_tpu_torch.ops.film_qkv import film_qkv_bwd_plain

    args, go = _prologue_args(B, L, C, F, seed=12), randn(20, B, L, F)
    _, vjp = jax.vjp(lambda *a: film_qkv(*a, tile, True), *map(jnp.asarray, args))
    got = film_qkv_bwd_plain(*map(T, args), T(go))
    for name, g, want in zip(PROLOGUE_GRADS, got, vjp(jnp.asarray(go))):
        assert g.shape == want.shape, name
        np.testing.assert_allclose(N(g), np.asarray(want), rtol=3e-4, atol=3e-4, err_msg=name)


@pytest.mark.parametrize("B,L,C,H,K,tile", [(2, 70, 16, 20, 5, 32), (3, 33, 8, 12, 3, 16)])
def test_swiglu_bwd_plain_matches_pallas_full_interpret(B, L, C, H, K, tile):
    """``swiglu_bwd_plain`` (K5's plain version, as K6's) against the JAX
    full-accumulator backward K5 replaces, in interpret mode (2e-4 as in
    tests/test_ops.py)"""
    from osu_dreamer_tpu.ops.swiglu import _fused_swiglu_bwd_impl
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu_bwd_plain

    x, w, go = randn(0, B, L, C), ffn_weights(C, H, K, 1), randn(9, B, L, C)
    want = _fused_swiglu_bwd_impl(*map(jnp.asarray, (x, *w[:5], go)), tile=tile, interpret=True)
    got = swiglu_bwd_plain(T(x), *map(T, w[:5]), T(go))
    for name, g, ref in zip(SWIGLU_GRADS, got, want):
        np.testing.assert_allclose(N(g), np.asarray(ref), atol=2e-4, rtol=2e-4, err_msg=name)


def test_bwd_kernel_feasible_matches_jax():
    """the copied dispatch rule between K5 and K6 equals the JAX one over a
    grid of widths, expansions and conv widths (the denoiser's hidden width
    int(C * expand * 2 / 3))"""
    from osu_dreamer_tpu.ops.swiglu import bwd_kernel_feasible as jfeasible
    from osu_dreamer_tpu_torch.ops.swiglu import bwd_kernel_feasible

    for C in (16, 128, 256, 384, 512, 768):
        for expand in (2, 4):
            for K in (3, 5):
                H = int(C * expand * 2 / 3)
                assert bwd_kernel_feasible(C, H, K) == jfeasible(C, H, K), (C, H, K)
    assert not bwd_kernel_feasible(512, 1365, 5)
    assert bwd_kernel_feasible(384, 1024, 5)
    assert bwd_kernel_feasible(256, 682, 5) and bwd_kernel_feasible(128, 341, 5)


def _attention_case(B: int = 2, L: int = 20, C: int = 128):
    x, add = randn(0, B, L, C), randn(1, B, L, C, scale=0.5)
    film = (randn(2, B, C, scale=0.3), randn(3, B, C, scale=0.3))
    return x, film, add


def test_rope_attention_fused_prologue_matches_jax(monkeypatch):
    """the port's RoPEAttention with OSU_DREAMER_FUSED_PROLOGUE=1 (on the CPU
    its prologue is ``film_qkv_plain``) against the JAX module taking its
    fused prologue in interpret mode (tests/test_ops.py's monkeypatch), the
    same flax weights: the forward, and the gradients of a weighted sum of
    the output with respect to x, scale, shift, add, the qkv kernel and bias"""
    import osu_dreamer_tpu.nn.attention as jattn
    import osu_dreamer_tpu.ops.film_qkv as jfq
    from osu_dreamer_tpu_torch.nn import attention as tattn

    x, film, add = _attention_case()
    jm = jattn.RoPEAttention(n_heads=2, head_dim=64, out_dim=96, dtype=F32)
    tree = fill_tree(jm.init(KEY, x, film=film, add=add), 5)
    weight = randn(7, 2, 20, 96)

    jax_calls, port_calls = [], []
    orig = jfq.film_qkv
    monkeypatch.setattr(jfq, "film_qkv", lambda *a: jax_calls.append(1) or orig(*a, 16, True))
    monkeypatch.setattr(jattn, "_prologue_ok", lambda C_, F_: True)

    def jloss(params, x, scale, shift, add):
        out = jm.apply(params, x, film=(scale, shift), add=add)
        return (out * weight).sum(), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        tree, x, *film, add)
    assert jax_calls

    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "1")
    dispatch = tattn.film_qkv
    monkeypatch.setattr(tattn, "film_qkv", lambda *a: port_calls.append(1) or dispatch(*a))
    tm = port(tattn.RoPEAttention(128, 2, 64, 96, torch.float32), tree)
    leaves = [T(a).requires_grad_() for a in (x, *film, add)]
    got = tm(leaves[0], film=(leaves[1], leaves[2]), add=leaves[3])
    assert port_calls == [1]
    np.testing.assert_allclose(N(got), np.asarray(want), atol=2e-5)

    params = [tm.qkv.kernel, tm.qkv.bias]
    grads = torch.autograd.grad((got * T(weight)).sum(), leaves + params)
    jparams, *jinputs = jgrads
    wants = [*jinputs, jparams["params"]["qkv"]["kernel"], jparams["params"]["qkv"]["bias"]]
    for name, g, w in zip(("x", "scale", "shift", "add", "qkv kernel", "qkv bias"), grads, wants):
        w = np.asarray(w)
        np.testing.assert_allclose(N(g), w, atol=2e-5 * np.abs(w).max(), rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("setting,C,calls", [(None, 128, 0), ("0", 128, 0), ("1", 128, 1),
                                             ("1", 96, 0)])
def test_fused_prologue_only_where_set(monkeypatch, setting, C, calls):
    """``film_qkv`` runs only with the variable set to 1 and lane-aligned
    widths; otherwise the path is the unfused one, and both give the same
    output"""
    from osu_dreamer_tpu_torch.nn import attention as tattn
    from osu_dreamer_tpu_torch.ops.film_qkv import film_qkv_plain

    seen = []
    monkeypatch.setattr(tattn, "film_qkv", lambda *a: seen.append(1) or film_qkv_plain(*a))
    if setting is None:
        monkeypatch.delenv("OSU_DREAMER_FUSED_PROLOGUE", raising=False)
    else:
        monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", setting)
    x, film, add = _attention_case(C=C)
    module = tattn.RoPEAttention(C, 2, 64, 32, torch.float32)
    module.qkv.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = module(T(x), film=(T(film[0]), T(film[1])), add=T(add))
        assert len(seen) == calls
        monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "0")
        want = module(T(x), film=(T(film[0]), T(film[1])), add=T(add))
    np.testing.assert_allclose(N(got), N(want), atol=1e-5)


def test_film_qkv_function_routes_through_kernels(monkeypatch):
    """``film_qkv`` sends a CUDA tensor through ``FilmQKVFunction`` (K11
    forward, K12 backward), wired here with the kernels' plain stand-ins:
    the graph node is the Function's, every input gets its gradient in its
    own dtype, equal to autograd of the plain version"""
    from osu_dreamer_tpu_torch.ops import film_qkv as fq
    from test_torch_ops import _CudaLooking

    calls = []
    monkeypatch.setattr(fq, "film_qkv_fwd_cuda",
                        lambda *a: calls.append("fwd") or fq.film_qkv_plain(*a))
    monkeypatch.setattr(fq, "film_qkv_bwd_cuda",
                        lambda *a: calls.append("bwd") or fq.film_qkv_bwd_plain(*a))
    leaves = [T(a).requires_grad_() for a in _prologue_args(2, 19, 16, 48)]
    out = fq.film_qkv(leaves[0].as_subclass(_CudaLooking), *leaves[1:])
    assert type(out.grad_fn).__name__ == "FilmQKVFunctionBackward"
    grads = torch.autograd.grad(out.square().sum(), leaves)
    want = torch.autograd.grad(fq.film_qkv_plain(*leaves).square().sum(), leaves)
    assert calls == ["fwd", "bwd"]
    for g, r, t in zip(grads, want, leaves):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(N(g), N(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C,H,backward", [(512, 1365, "swiglu_bwd"), (384, 1024, "swiglu_bwd_full"),
                                          (128, 341, "swiglu_bwd_full")])
def test_swiglu_function_takes_the_jax_backward(monkeypatch, C, H, backward):
    """``SwiGLUFunction``'s backward is K5 where the JAX dispatch takes its
    full backward and K6 elsewhere (the kernels stood in by the plain
    version, named by which one ran)"""
    from osu_dreamer_tpu_torch.ops import swiglu as sw

    ran = []
    monkeypatch.setattr(sw, "swiglu_cuda", sw.swiglu_plain)
    for name in ("swiglu_bwd", "swiglu_bwd_full"):
        monkeypatch.setattr(sw, f"{name}_cuda",
                            lambda *a, name=name: ran.append(name) or sw.swiglu_bwd_plain(*a))
    leaves = [T(randn(0, 1, 6, C)), *map(T, ffn_weights(C, H, 5, 1))]
    leaves = [t.requires_grad_() for t in leaves]
    torch.autograd.grad(sw.SwiGLUFunction.apply(*leaves).sum(), leaves)
    assert ran == [backward]
