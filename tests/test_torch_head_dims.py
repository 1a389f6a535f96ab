"""Head dims 32 and 128 (32 x 32 and 8 x 128 heads, the shipped H D of
1024), on the CPU in f32 against the JAX package:

- the flash attention's numerics (tests/test_torch_flash.py's emulation of
  csrc/flash_attention.cu) at head dims 32 and 128 under the kernel's 4-ulp
  rule, at the sampler's L 759 and K8's L 2500;
- ``RoPEAttention`` at 8 x 128 and 32 x 32 heads on a narrow input, and the
  whole denoiser with ``backbone: {n_heads: 8, head_dim: 128}``, narrow and
  two layers deep, against the flax modules, weights carried by
  ``from_flax_params`` (the (D,) q/k gains and the (C, 3 H D) qkv kernel);
  both through the fused route (L <= 256) and the long one.
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
    assert attention_route(L, H, D, "cpu") == ("fused" if fused_attention_fits(L, H, D)
                                               else "long")
    attention_route(L, H, D, "cuda")  # the card takes the head dim: no raise
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
