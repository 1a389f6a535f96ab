"""Random Fourier features.

Counterpart of osu_dreamer_tpu/nn/features.py: fixed ``W ~ N(0, n_bins^2)``,
phase ``b ~ U(-pi, pi)``, output ``sqrt(2/F) * cos(x W + b)``. The JAX package
draws W and b from ``jax.random.PRNGKey(0x05EED)``, which torch cannot
reproduce, so the unit draws are committed in ``rff_tables.npz`` (written once
by the JAX package; tests/test_torch_modules.py pins them to it) for an input
width of 1 and feature counts 16 to 256.
"""

from __future__ import annotations

from functools import cache
from pathlib import Path

import numpy as np
import torch

_TABLES = Path(__file__).with_name("rff_tables.npz")


@cache
def _unit_tables(in_dim: int, features: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    with np.load(_TABLES) as t:
        key = f"W_{in_dim}x{features}"
        if key not in t:
            raise KeyError(f"no committed RFF table for in_dim={in_dim}, features={features}")
        return torch.from_numpy(t[key]).to(device), torch.from_numpy(t[f"b_{features}"]).to(device)


def fourier_features(x: torch.Tensor, features: int, n_bins: int = 16) -> torch.Tensor:
    """(..., I) -> (..., features) random Fourier embedding"""
    W, b = _unit_tables(x.shape[-1], features, x.device)
    scale = (2.0 / features) ** 0.5
    return (scale * torch.cos(x.float() @ (W * float(n_bins)) + b)).to(x.dtype)
