"""RMS normalization over the channel (last) dimension.

Counterpart of osu_dreamer_tpu/nn/norm.py: f32 statistics whatever the
compute dtype, eps 1e-6, the result cast back to the compute dtype BEFORE the
optional gain is applied (in that dtype).
"""

from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, gamma: torch.Tensor | None = None) -> torch.Tensor:
    """normalize channels (last dim) to unit RMS; statistics in f32"""
    xf = x.float()
    out = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)).to(x.dtype)
    if gamma is not None:
        out = out * gamma.to(x.dtype)
    return out


class RMSNorm(nn.Module):
    """affine RMS norm; ``gain`` is the flax module's gamma init value"""

    def __init__(self, dim: int, gain: float = 1.0):
        super().__init__()
        self.gain = float(gain)
        self.gamma = nn.Parameter(torch.full((dim,), self.gain))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.gain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.gamma)
