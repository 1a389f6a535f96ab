"""The flash attention kernel's numerics, emulated on the CPU, against the
plain version, before any card runs it.

``osu_dreamer_tpu_torch/csrc/flash_attention.cu`` walks the keys in tiles of
KEY_TILE with an online softmax: raw logits q.k in f32, running row maxima,
probabilities exp2((s - m) * scale * log2(e)) left unnormalised and rounded to
bf16 for P @ V with an f32 accumulator, the row sums in f32 from the unrounded
probabilities, keys past L masked to -1e30, and one multiplication by 1 / l
at the end. ``flash_emulation`` does the same in torch, tile by tile. It is
held to ``attention_plain`` in bf16 (normalised probabilities rounded to
bf16) under the 4-ulp rule that chip_smoke.py and test_torch_kernels_gpu.py
apply to the kernel, so the tolerance is known to hold for the algorithm
before the kernel is timed.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.ops.long_attention import attention_plain
from test_torch_modules import randn

torch.set_num_threads(1)

KEY_TILE = 64  # kFaBK in csrc/flash_attention.cu
BF16_ULPS = 4
NEG = -1e30


def flash_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale_dim: int | None = None, with_lse: bool = False):
    """(B, L, H, D) bf16 -> (B, L, H*D) bf16, the kernel's arithmetic; the
    softmax scale is ``scale_dim`` ** -0.5 (default D: the head dim before
    any zero padding); ``with_lse`` also returns (B, H, L) m scale + ln l"""
    B, L, H, D = q.shape
    scale = (scale_dim or D) ** -0.5
    c = scale * math.log2(math.e)
    # keys zero-filled to whole tiles, as the tensor map's loads fill them
    Lk = -(-L // KEY_TILE) * KEY_TILE
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, L, D)
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, Lk - L)).permute(0, 2, 1, 3)
              for t in (k, v))
    m = torch.full((B, H, L, 1), NEG)
    l = torch.zeros(B, H, L, 1)
    acc = torch.zeros(B, H, L, D)
    for k0 in range(0, Lk, KEY_TILE):
        s = qf @ kf[:, :, k0:k0 + KEY_TILE].transpose(-1, -2)  # raw logits, f32
        s = s.masked_fill(torch.arange(k0, k0 + KEY_TILE) >= L, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + KEY_TILE]
        m = m_new
    out = (acc * (1.0 / l)).to(torch.bfloat16)
    out = out.permute(0, 2, 1, 3).reshape(B, L, H * D)
    if with_lse:
        return out, (m * scale + torch.log(l))[..., 0]
    return out


def stream_flash_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           with_lse: bool = False):
    """csrc/attention_stream.cu's forward: q, k, v zero-padded to whole
    64-column boxes (the wrapper's pad to a multiple of 8, then the tensor
    map's zero fill), S summed over the boxes, the online softmax of
    ``flash_emulation`` at the real head dim's scale, O cut back to D"""
    B, L, H, D = q.shape
    boxes = -(-D // 64) * 64
    padded = [torch.nn.functional.pad(t, (0, boxes - D)) for t in (q, k, v)]
    out = flash_emulation(*padded, scale_dim=D, with_lse=with_lse)
    o = out[0] if with_lse else out
    o = o.reshape(B, L, H, boxes)[..., :D].reshape(B, L, H * D)
    return (o, out[1]) if with_lse else o


@pytest.mark.parametrize("B,L,H", [(4, 759, 2), (1, 2500, 2), (1, 1, 2)])
def test_flash_numerics_hold_the_kernel_tolerance(B, L, H):
    """the sampler's B4 L759, K8's range (a ragged last tile each) and a
    single key; random bf16 inputs of unit scale as chip_smoke.py draws"""
    q, k, v = (torch.from_numpy(randn(s, B, L, H, 64)).to(torch.bfloat16) for s in (1, 2, 3))
    got = flash_emulation(q, k, v).float()
    want = attention_plain(q, k, v).float()
    assert got.shape == want.shape == (B, L, H * 64)
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    err = (got - want).abs().max().item()
    assert err <= tol, f"max abs err {err:.4g} > {tol:.4g}"



# the streamed kernel's head dims: padded to a multiple of 8 (12), one box a
# head (48), two (96), four boxes split over two CTAs (256)
@pytest.mark.parametrize("D", [12, 48, 96, 256])
@pytest.mark.parametrize("B,L", [(2, 759), (1, 65), (1, 1)])
def test_stream_flash_numerics_at_head_dims(B, L, D):
    """the streamed forward's order at head dims off the templated ones, 4
    ulp of ``attention_plain`` (bf16) and within 1 % of the largest
    magnitude of the JAX reference (``jax.nn.dot_product_attention``, as
    ``long_flash_attention``'s ``_xla_reference``) in f32 on the same
    inputs: P rounded to bf16 (2^-9 relative) is the only difference"""
    import jax
    import jax.numpy as jnp

    H = 2
    q, k, v = (torch.from_numpy(randn(s + D, B, L, H, D)).to(torch.bfloat16) for s in (1, 2, 3))
    got = stream_flash_emulation(q, k, v).float()
    want = attention_plain(q, k, v).float()
    assert got.shape == want.shape == (B, L, H * D)
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol
    ref = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))).reshape(B, L, H * D)
    assert np.abs(got.numpy() - ref).max() <= 0.01 * np.abs(ref).max()
