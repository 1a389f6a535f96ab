"""Training past the JAX fused-attention gate, on the CPU in f32 against the
JAX package:

- the gradients of the port's ``long_flash_attention`` (ops/long_attention.py:
  on CPU tensors autograd of ``attention_plain``, the plain version of the
  card's streamed forward and long attention backward) against the JAX
  ``long_flash_attention`` VJP (the Pallas forward in interpret mode; its
  backward is the vjp of ``_xla_reference``) at head dims 8, 12, 64 and 96
  and L 1, 65 and 300: within 1e-5 of the largest gradient magnitude (f32 on
  both sides; the sums differ only in their order);
- one training step of the narrow denoiser at the shipped 16 x 64 heads and
  L 300 (L H D 307,200, past the gate) against the JAX step on transplanted
  parameters (the tolerances of tests/test_torch_head_dims.py);
- the route of that shape and ``fit.run``'s want of any refusal there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.mark.parametrize("L", [1, 65, 300])
@pytest.mark.parametrize("D", [8, 12, 64, 96])
def test_long_attention_gradients_match_the_jax_vjp(D, L):
    import jax
    import jax.numpy as jnp

    from osu_dreamer_tpu.ops.long_attention import long_flash_attention as jax_attention
    from osu_dreamer_tpu_torch.ops.long_attention import attention_bwd_plain, long_flash_attention

    B, H = 2, 2
    rng = np.random.default_rng(D * 1000 + L)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    grad = rng.standard_normal((B, L, H * D)).astype(np.float32)
    want_out, pullback = jax.vjp(lambda a, b, c: jax_attention(a, b, c, True),
                                 *map(jnp.asarray, (q, k, v)))
    want = pullback(jnp.asarray(grad))

    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = long_flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(grad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5)
    plain = attention_bwd_plain(*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(grad))
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        w = np.asarray(w)
        assert g.shape == (B, L, H, D)
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    if L == 1:  # one key: the softmax is 1 whatever the logits, so dq and dk vanish
        assert not got[0].any() and not got[1].any()


def test_denoiser_trains_at_16_by_64_heads_past_the_gate():
    """the shipped 16 x 64 heads at L 300 route to the long attention, and
    one f32 step of the narrow denoiser there (loss terms and every gradient
    leaf) equals the JAX step"""
    from osu_dreamer_tpu_torch.models.diffusion import fit
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route
    from test_torch_head_dims import train_step_against_jax

    assert attention_route(300, 16, 64) == "long"
    assert not hasattr(fit, "check_attention_shape")
    train_step_against_jax(16, 64, 300)
