"""Attention pooling: sequence -> one vector.

Counterpart of osu_dreamer_tpu/nn/pool.py (``AttnPool``): per-head softmax
scores over the sequence (f32), a score-weighted sum of the values, the
flattened heads projected to the output width. Child names follow flax
(``scores``, ``values``, ``out``).
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import Dense


class AttnPool(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, head_dim: int, n_heads: int,
                 dtype: torch.dtype):
        super().__init__()
        self.head_dim, self.n_heads = head_dim, n_heads
        self.scores = Dense(in_dim, n_heads, dtype)
        self.values = Dense(in_dim, n_heads * head_dim, dtype)
        self.out = Dense(n_heads * head_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, C) -> (B, out_dim)"""
        B, L, _ = x.shape
        weights = torch.softmax(self.scores(x).float(), dim=1).to(x.dtype)  # (B, L, H)
        values = self.values(x).reshape(B, L, self.n_heads, self.head_dim)
        pooled = torch.einsum("blh,blhd->bhd", weights, values).reshape(B, -1)
        return self.out(pooled)
