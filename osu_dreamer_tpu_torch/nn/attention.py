"""RoPE self-attention.

Counterpart of osu_dreamer_tpu/nn/attention.py (``rope``, ``RoPEAttention``):
packed qkv projection (optionally after a pre-norm FiLM and an added
stream), per-head RMS norm of q and k with learned gains, rotary position
embedding, softmax attention (ops/long_attention.py), output projection.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.long_attention import long_flash_attention
from .blocks import Dense
from .norm import rms_norm


def rope(x: torch.Tensor) -> torch.Tensor:
    """rotary position embedding over (B, L, H, D) with even D"""
    _, L, _, D = x.shape
    if D % 2:
        raise ValueError("head_dim must be even")
    inv_freq = 10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / -D)
    positions = torch.arange(L, dtype=torch.float32, device=x.device)
    angles = positions[:, None] * inv_freq[None, :]  # (L, D/2)
    cos = angles.cos().to(x.dtype)[None, :, None, :]
    sin = angles.sin().to(x.dtype)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class RoPEAttention(nn.Module):
    """multi-head self-attention over (B, L, C) with RoPE and q/k norms"""

    def __init__(self, in_dim: int, n_heads: int, head_dim: int, out_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.n_heads, self.head_dim, self.dtype = n_heads, head_dim, dtype
        self.qkv = Dense(in_dim, 3 * n_heads * head_dim, dtype)
        self.q_gamma = nn.Parameter(torch.ones(head_dim))
        self.k_gamma = nn.Parameter(torch.ones(head_dim))
        self.out = Dense(n_heads * head_dim, out_dim, dtype)

    def forward(
        self,
        x: torch.Tensor,
        film: tuple[torch.Tensor, torch.Tensor] | None = None,
        add: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``film=(scale, shift)`` (each (B, C)) applies the caller's pre-norm
        FiLM before the qkv projection; ``add`` is a position-local stream
        added after it"""
        dt = self.dtype
        B, L, _ = x.shape
        H, D = self.n_heads, self.head_dim
        if film is None:
            h = x.to(dt)
        else:
            scale, shift = film
            h = rms_norm(x) * (1 + scale[:, None, :].to(dt)) + shift[:, None, :].to(dt)
        if add is not None:
            h = h + add.to(dt)
        q, k, v = self.qkv(h).split(H * D, dim=-1)
        q = rope(rms_norm(q.reshape(B, L, H, D), self.q_gamma))
        k = rope(rms_norm(k.reshape(B, L, H, D), self.k_gamma))
        y = long_flash_attention(q, k, v.reshape(B, L, H, D).contiguous())
        return self.out(y)
