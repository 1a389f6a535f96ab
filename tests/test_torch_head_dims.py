"""Head dims and lengths off the shipped 16 x 64 at L <= 256, on the CPU in
f32 against the JAX package:

- head dims 32 and 128 (32 x 32 and 8 x 128 heads, the shipped H D of
  1024): the flash attention's numerics (tests/test_torch_flash.py's
  emulation of csrc/flash_attention.cu) under the kernel's 4-ulp rule, at
  the sampler's L 759 and K8's L 2500; ``RoPEAttention`` and the whole
  denoiser with ``backbone: {n_heads: 8, head_dim: 128}``, narrow and two
  layers deep, against the flax modules, weights carried by
  ``from_flax_params`` (the (D,) q/k gains and the (C, 3 H D) qkv kernel),
  both through the fused route (L <= 256) and the long one;
- the JAX gate's whole range, which the card runs on the streamed kernels
  (csrc/attention_stream.cu): ``RoPEAttention`` and the narrow denoiser at
  8 x 96 heads through the fused route (L 320) and the long one (L 759), and
  one training step's gradients at 8 x 96, L 320 and 8 x 64, L 512.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_flash import BF16_ULPS, flash_emulation
from test_torch_modules import F32, KEY, N, T, fill_tree, port, randn, tiny_args

torch.set_num_threads(1)


@pytest.mark.parametrize("B,L,D", [(4, 759, 32), (4, 759, 128), (1, 2500, 128), (1, 65, 32)])
def test_flash_numerics_hold_the_kernel_tolerance_at_head_dims(B, L, D):
    from osu_dreamer_tpu_torch.ops.long_attention import attention_plain

    H = 2
    q, k, v = (torch.from_numpy(randn(s, B, L, H, D)).to(torch.bfloat16) for s in (4, 5, 6))
    got = flash_emulation(q, k, v).float()
    want = attention_plain(q, k, v).float()
    assert got.shape == want.shape == (B, L, H * D)
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("H,D,L", [(8, 128, 37), (32, 32, 37), (8, 128, 300), (4, 32, 300)])
def test_rope_attention_at_head_dims(H, D, L):
    """8 x 128 and 32 x 32 heads take the fused route at L 37 (the JAX gate
    holds), 8 x 128 the long one at L 300; the gains are (D,)"""
    from osu_dreamer_tpu.nn.attention import RoPEAttention as JAttn
    from osu_dreamer_tpu_torch.nn.attention import RoPEAttention as TAttn
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route, fused_attention_fits

    x = randn(0, 2, L, 24)
    film = (randn(2, 2, 24, scale=0.3), randn(3, 2, 24, scale=0.3))
    jm = JAttn(n_heads=H, head_dim=D, out_dim=20, dtype=F32)
    tree = fill_tree(jm.init(KEY, x, film=film), 4)
    tm = port(TAttn(24, H, D, 20, torch.float32), tree)
    assert tm.q_gamma.shape == tm.k_gamma.shape == (D,)
    assert tuple(tm.qkv.kernel.shape) == (24, 3 * H * D)
    np.testing.assert_array_equal(N(tm.q_gamma), np.asarray(tree["params"]["q_gamma"]))
    assert attention_route(L, H, D) == ("fused" if fused_attention_fits(L, H, D) else "long")
    got = tm(T(x), film=(T(film[0]), T(film[1])))
    np.testing.assert_allclose(N(got), np.asarray(jm.apply(tree, x, film=film)), atol=1e-5)


def _wide_heads(args):
    return dataclasses.replace(args, backbone_dim=32, backbone=dataclasses.replace(
        args.backbone, n_heads=8, head_dim=128, depth=2))


@pytest.mark.parametrize("L", [13, 300])
def test_denoiser_at_8_by_128_heads(L):
    """the whole denoiser (backbone width 32, two layers, 8 x 128 heads)
    against flax: predict at L 13 (fused route) and 300 (long route), and
    the sphere-tracing sampler on the same noise"""
    import jax

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel as TDiff

    ja, ta = _wide_heads(tiny_args("jax").diffusion), _wide_heads(tiny_args("torch").diffusion)
    audio, style, xt = randn(0, 1, L, 16), randn(1, 2, 8), randn(2, 2, L, 4)
    jm = JDiff(ja, F32)
    tree = fill_tree(jm.init(KEY, audio, style, xt), 8)
    tm = port(TDiff(ta, torch.float32), tree)
    u_j, v_j = jm.apply(tree, audio, style, xt)
    u_t, v_t = tm.predict(*tm.precompute_cond(T(audio), T(style)), T(xt))
    np.testing.assert_allclose(N(u_t), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(N(v_t), np.asarray(v_j), atol=1e-5)

    rng = jax.random.PRNGKey(13)
    x0 = np.asarray(jax.random.normal(rng, (2, L, ta.emb_dim), F32))
    want = jm.apply(tree, audio, style, rng, 2, method=JDiff.sample)
    got = tm.sample(T(audio), T(style), 2, x0=T(x0))
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-4)


# ---- the JAX gate's whole range: 8 x 96 heads and lengths past 256 ----

@pytest.mark.parametrize("L", [320, 759])
def test_rope_attention_at_8_by_96_heads(L):
    """8 x 96 heads take the fused route at L 320 (L H D 245,760, inside the
    JAX gate), the long one at L 759, on every device; the module against
    flax"""
    from osu_dreamer_tpu.nn.attention import RoPEAttention as JAttn
    from osu_dreamer_tpu_torch.nn.attention import RoPEAttention as TAttn
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route

    H, D = 8, 96
    x = randn(5, 1, L, 24)
    film = (randn(6, 1, 24, scale=0.3), randn(7, 1, 24, scale=0.3))
    jm = JAttn(n_heads=H, head_dim=D, out_dim=20, dtype=F32)
    tree = fill_tree(jm.init(KEY, x, film=film), 5)
    tm = port(TAttn(24, H, D, 20, torch.float32), tree)
    want = "fused" if L == 320 else "long"
    assert attention_route(L, H, D) == want
    got = tm(T(x), film=(T(film[0]), T(film[1])))
    np.testing.assert_allclose(N(got), np.asarray(jm.apply(tree, x, film=film)), atol=1e-5)


def _heads_96(args):
    return dataclasses.replace(args, backbone_dim=32, backbone=dataclasses.replace(
        args.backbone, n_heads=8, head_dim=96, depth=2))


@pytest.mark.parametrize("L", [320, 759])
def test_denoiser_at_8_by_96_heads(L):
    """the whole narrow denoiser (width 32, two layers, 8 x 96 heads)
    against flax: predict at L 320 (fused route) and L 759 (long route)"""
    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel as TDiff

    ja, ta = _heads_96(tiny_args("jax").diffusion), _heads_96(tiny_args("torch").diffusion)
    audio, style, xt = randn(0, 1, L, 16), randn(1, 1, 8), randn(2, 1, L, 4)
    jm = JDiff(ja, F32)
    tree = fill_tree(jm.init(KEY, audio, style, xt), 9)
    tm = port(TDiff(ta, torch.float32), tree)
    u_j, v_j = jm.apply(tree, audio, style, xt)
    u_t, v_t = tm.predict(*tm.precompute_cond(T(audio), T(style)), T(xt))
    np.testing.assert_allclose(N(u_t), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(N(v_t), np.asarray(v_j), atol=1e-5)


@pytest.mark.parametrize("H,D,L", [(8, 96, 320), (8, 64, 512)])
def test_train_step_gradients_inside_the_gate(H, D, L):
    """one f32 training step's loss terms and every gradient leaf of the
    narrow denoiser at 8 x 96 heads, L 320 and 8 x 64 heads, L 512 (both
    inside the JAX gate, so the card trains them on K9/K10) against the JAX
    step on transplanted parameters, the draws injected (the tolerances of
    tests/test_torch_train.py)"""
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route

    assert attention_route(L, H, D) == "fused"
    train_step_against_jax(H, D, L)


def train_step_against_jax(H: int, D: int, L: int) -> None:
    """one f32 training step of the narrow denoiser (backbone width 32) at H
    x D heads over L frames: the loss terms within 1e-5 and every gradient
    leaf within 2e-5 of the largest of the JAX step on transplanted
    parameters, the draws injected"""
    import jax

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel as TDiff
    from osu_dreamer_tpu_torch.models.diffusion.train import LatentBatch, diffusion_loss
    from osu_dreamer_tpu_torch.models.inference.artifact import _flatten
    from test_torch_train import _args

    (ja, jt), (ta, tt) = _args("jax"), _args("torch")
    ja, ta = (dataclasses.replace(a, backbone_dim=32, backbone=dataclasses.replace(
        a.backbone, n_heads=H, head_dim=D)) for a in (ja, ta))
    B = 2
    rng = np.random.default_rng(L)
    z = rng.standard_normal((B, L, 6)).astype(np.float32)
    batch_np = (rng.random((B, L, 16), dtype=np.float32), z,
                rng.standard_normal((B, 8)).astype(np.float32),
                rng.uniform(0, 10, (B, 5)).astype(np.float32))
    jm = JDiff(ja, F32)
    tree = fill_tree(jax.jit(jm.init)(KEY, batch_np[0], batch_np[2], z), 23)
    step_rng = jax.random.PRNGKey(7)
    (_, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, step_rng, JBatch(*batch_np), jt), has_aux=True))(tree)
    k_t, k_noise = jax.random.split(step_rng)
    t = T(stratified_logit_normal_t(k_t, B))
    x0 = T(jax.random.normal(k_noise, z.shape, F32))
    model = port(TDiff(ta, torch.float32), tree)
    _, aux_t = diffusion_loss(model, LatentBatch(*map(T, batch_np)), tt, t=t, x0=x0)
    grads_t = dict(zip([k for k, _ in model.named_parameters()],
                       torch.autograd.grad(aux_t["loss"], list(model.parameters()))))
    for name in ("loss", "osl", "del", "u_mape"):
        np.testing.assert_allclose(N(aux_t[name]), np.asarray(aux_j[name]), rtol=1e-5,
                                   err_msg=name)
    gmax = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads_j))
    for key, want in _flatten(grads_j["params"]).items():
        np.testing.assert_allclose(N(grads_t[key]), np.asarray(want), atol=2e-5 * gmax,
                                   err_msg=key)
