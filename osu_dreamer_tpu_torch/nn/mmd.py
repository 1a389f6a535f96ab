"""WAE-MMD regulariser: unbiased MMD^2 with inverse-multiquadratic kernels.

Counterpart of osu_dreamer_tpu/nn/mmd.py: pulls the aggregate posterior of
the style code towards N(0, I); 7 IMQ kernel scales with C = 2d * s, all in
f32.
"""

from __future__ import annotations

import torch

_SCALES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)


def _imq_kernel_sum(sq_dists: torch.Tensor, c_base: float) -> torch.Tensor:
    out = torch.zeros_like(sq_dists)
    for s in _SCALES:
        c = c_base * s
        out = out + c / (c + sq_dists)
    return out


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = (a * a).sum(-1)
    bb = (b * b).sum(-1)
    return (aa[:, None] + bb[None, :] - 2.0 * a @ b.T).clamp_min(0.0)


def mmd_imq(z: torch.Tensor, z_prior: torch.Tensor) -> torch.Tensor:
    """unbiased MMD^2 between (N, E) samples and (N, E) prior draws"""
    n, d = z.shape
    c_base = 2.0 * d
    z, z_prior = z.float(), z_prior.float()
    off_diag = 1.0 - torch.eye(n, dtype=torch.float32, device=z.device)
    kzz = _imq_kernel_sum(_pairwise_sq_dists(z, z), c_base)
    kpp = _imq_kernel_sum(_pairwise_sq_dists(z_prior, z_prior), c_base)
    kzp = _imq_kernel_sum(_pairwise_sq_dists(z, z_prior), c_base)
    denom = n * (n - 1)
    return (kzz * off_diag).sum() / denom + (kpp * off_diag).sum() / denom - 2.0 * kzp.mean()
