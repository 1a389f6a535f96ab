"""Stage-3 style prior: 5 difficulty labels -> style code.

Counterpart of osu_dreamer_tpu/models/style/model.py: labels embedded with
random Fourier features and a per-label projection (a negative label selects
the learned null row), a FiLM-gated MLP that predicts the distance u and the
direction v, and self-calibrating sphere tracing with optional
classifier-free guidance over the null labels. ``init_params`` draws flax's
initialisation of ``StyleModel.init``.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import sqrt

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.blocks import MLP, Dense
from ...nn.features import fourier_features
from ...nn.norm import rms_norm
from ...signal.constants import NUM_LABELS

_T99 = 0.9110007125548362
_U_BIAS_INIT = -0.4328


@dataclass
class StyleModelArgs:
    style_dim: int = 32
    label_features: int = 128
    h_dim: int = 256
    depth: int = 8
    expand: int = 4
    dropout: float = 0.0

    @property
    def d0_sq(self) -> float:
        return 2.0 * self.style_dim

    @property
    def c0(self) -> float:
        return (1.0 - _T99) ** 2 * self.d0_sq

    @property
    def u_scale(self) -> float:
        return sqrt(self.d0_sq)


class StyleModel(nn.Module):
    def __init__(self, args: StyleModelArgs, dtype: torch.dtype):
        super().__init__()
        a = args
        self.args, self.dtype = args, dtype
        self.label_proj_w = nn.Parameter(torch.zeros(NUM_LABELS, a.label_features, a.h_dim))
        self.label_proj_b = nn.Parameter(torch.zeros(NUM_LABELS, a.h_dim))
        self.null_labels = nn.Parameter(torch.zeros(NUM_LABELS, a.h_dim))
        self.proj_in = Dense(a.style_dim, a.h_dim, dtype)
        for i in range(a.depth):
            self.add_module(f"film{i}", Dense(a.h_dim, 3 * a.h_dim, dtype, zero_init=True))
            self.add_module(f"block{i}", MLP(a.h_dim, a.expand * a.h_dim, a.h_dim, dtype))
        self.out_gamma = nn.Parameter(torch.ones(a.h_dim))
        self.proj_out = Dense(a.h_dim, a.style_dim, dtype, zero_init=True)
        self.u_out = Dense(a.h_dim, 1, dtype, zero_init=True, bias_init=_U_BIAS_INIT)

    def init_params(self, generator: torch.Generator) -> "StyleModel":
        """flax's initialisation of ``StyleModel.init``: xavier-uniform
        ``label_proj_w`` (fans over its (label, feature, out) axes), zero
        ``label_proj_b``, ``null_labels`` N(0, 1) / sqrt(h_dim), lecun_normal
        ``proj_in`` and block kernels, zero FiLM, ``proj_out`` and ``u_out``
        kernels, the u_out bias at -0.4328, unit ``out_gamma``; drawn from
        ``generator`` in module order"""
        a = self.args
        with torch.no_grad():
            fan_in, fan_out = NUM_LABELS * a.label_features, NUM_LABELS * a.h_dim
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            self.label_proj_w.uniform_(-limit, limit, generator=generator)
            self.label_proj_b.zero_()
            self.null_labels.normal_(generator=generator).mul_(a.h_dim**-0.5)
            self.out_gamma.fill_(1.0)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def embed_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, 5) in [0, 10] (or < 0 for "unspecified") -> (B, h_dim), f32"""
        x = labels[:, :, None]
        rff = fourier_features(x / 10.0, self.args.label_features, n_bins=32)
        h = torch.einsum("bnf,nfh->bnh", rff, self.label_proj_w) + self.label_proj_b
        h = torch.where(x < 0, self.null_labels[None], h)
        return h.sum(dim=1)

    def forward(self, st: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """noised style + labels -> (u (B,) f32, v (B, S))"""
        c = self.embed_labels(labels).to(self.dtype)
        x = self.proj_in(st)
        for i in range(self.args.depth):
            scale, shift, gate = getattr(self, f"film{i}")(c).chunk(3, dim=-1)
            h = rms_norm(x) * (1 + scale) + shift
            h = getattr(self, f"block{i}")(h)
            x = x + rms_norm(h) * gate
        v = self.proj_out(rms_norm(x, self.out_gamma))
        u = self.args.u_scale * F.softplus(self.u_out(rms_norm(x)).float())[:, 0]
        return u, v

    def sample(
        self,
        labels: torch.Tensor,
        num_steps: int = 16,
        guidance: float = 1.0,
        s0: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        batch_mean=None,
    ) -> torch.Tensor:
        """sphere tracing from ``s0`` (drawn N(0, 1) from ``generator`` when
        not given); step size calibrated on the device from the first
        conditional distance, so the loop never waits on the host.
        ``batch_mean`` (default the tensor's mean) takes that calibration's
        mean over the rows: a shard of a batch split over replicas passes
        the whole batch's (parallel/replicas.py).
        ``guidance`` != 1 extrapolates the displacement away from the
        null-label prediction (batch [cond; null])."""
        B = labels.shape[0]
        if s0 is None:
            s0 = torch.randn(B, self.args.style_dim, generator=generator, device=labels.device)
        guided = guidance != 1.0
        both = torch.cat([labels, torch.full_like(labels, -1.0)]) if guided else labels

        def displacement(s: torch.Tensor) -> torch.Tensor:
            if not guided:
                u, v = self(s, both)
                return u[:, None] * v.float()
            u, v = self(torch.cat([s, s]), both)
            d = u[:, None] * v.float()
            d_cond, d_null = d[:B], d[B:]
            return d_null + guidance * (d_cond - d_null)

        sqrt_c0 = sqrt(self.args.c0)
        u = self(s0, labels)[0]
        u0 = u.mean() if batch_mean is None else batch_mean(u)
        eta = 1.0 - (sqrt_c0 / u0.clamp_min(sqrt_c0 + 1e-6)) ** (1.0 / num_steps)
        s = s0
        for _ in range(num_steps):
            s = s - eta * displacement(s)
        return s
