"""Stage-2 latent denoiser: a distance-field flow model sampled by sphere
tracing.

Counterpart of osu_dreamer_tpu/models/diffusion/model.py (``BackboneLayer``,
``Backbone``, ``DiffusionModel.precompute_cond/predict/sample``). For a noised
latent x_t the model predicts the distance u to the data manifold and the
direction field v; sampling steps ``x <- x - eta * u * v`` with eta
calibrated on the device from the first prediction. ``forward`` is the
training call; ``init_params`` draws flax's initialisation. Dropout is not
ported.

Sequence parallelism: every call takes ``sp``, the group of ranks the window
length is sharded over (the JAX ``backbone.seq_axis``), each rank holding its
span. Attention becomes ring attention at the shard's global rotary offset,
the SwiGLU convs and the u-head's two radius-1 convs read halos from their
neighbours (each u-head conv its own 1-frame halo, so the second conv's edge
neighbour is a literal zero as in the unsharded stack), and the u-head's time
mean is all-reduced, so every rank carries the same u.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import sqrt

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.attention import RoPEAttention
from ...nn.blocks import Dense, DepthwiseConv, SwiGLU
from ...nn.norm import rms_norm
from ...ops.ring_attention import halo_exchange
from ...parallel.collectives import all_reduce_sum, group_rank, group_size

_T99 = 0.9110007125548362
# softplus(bias) = .5  =>  u starts at its marginal mean E[1-t]*u_scale
_U_BIAS_INIT = -0.4328


@dataclass
class BackboneArgs:
    depth: int = 8
    expand: int = 4
    head_dim: int = 64
    n_heads: int = 16
    radius: int = 2
    dropout: float = 0.0
    seq_axis: str | None = None


@dataclass
class DiffusionModelArgs:
    emb_dim: int = 6
    a_dim: int = 128
    style_dim: int = 32
    global_cond_dim: int = 512
    backbone_dim: int = 512
    u_head_dim: int = 64
    backbone: BackboneArgs = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.backbone is None:
            self.backbone = BackboneArgs()

    @property
    def d0_sq(self) -> float:
        return 2.0 * self.emb_dim

    @property
    def c0(self) -> float:
        return (1.0 - _T99) ** 2 * self.d0_sq

    @property
    def u_scale(self) -> float:
        return sqrt(self.d0_sq)


class BackboneLayer(nn.Module):
    """pre-norm transformer layer, doubly FiLM-gated by the global cond, with
    the audio features added ahead of attention"""

    def __init__(self, dim: int, a_dim: int, cond_dim: int, args: BackboneArgs,
                 dtype: torch.dtype):
        super().__init__()
        self.film_attn = Dense(cond_dim, 3 * dim, dtype, zero_init=True)
        self.attn = RoPEAttention(dim, args.n_heads, args.head_dim, dim, dtype)
        self.audio_proj = Dense(a_dim, dim, dtype)
        self.film_ffn = Dense(cond_dim, 3 * dim, dtype, zero_init=True)
        self.ffn = SwiGLU(dim, args.expand, args.radius, dtype)

    def forward(self, x: torch.Tensor, audio: torch.Tensor, cond: torch.Tensor,
                sp=None) -> torch.Tensor:
        scale, shift, gate = self.film_attn(cond).chunk(3, dim=-1)
        h = self.attn(x, film=(scale, shift), add=self.audio_proj(audio), sp=sp)
        x = x + rms_norm(h) * gate[:, None, :]
        scale, shift, gate = self.film_ffn(cond).chunk(3, dim=-1)
        h = rms_norm(x) * (1 + scale[:, None, :]) + shift[:, None, :]
        h = self.ffn(h, sp=sp)
        return x + rms_norm(h) * gate[:, None, :]


class Backbone(nn.Module):
    def __init__(self, dim: int, a_dim: int, cond_dim: int, args: BackboneArgs,
                 dtype: torch.dtype):
        super().__init__()
        self.depth = args.depth
        for i in range(args.depth):
            self.add_module(f"layer{i}", BackboneLayer(dim, a_dim, cond_dim, args, dtype))

    def forward(self, x: torch.Tensor, audio: torch.Tensor, cond: torch.Tensor,
                sp=None) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"layer{i}")(x, audio, cond, sp)
        return rms_norm(x)


class UConvs(nn.Module):
    """the distance head's conv stack, flax ``nn.Sequential`` child names:
    DepthwiseConv, Dense, silu, DepthwiseConv, Dense, silu"""

    def __init__(self, emb_dim: int, u_dim: int, dtype: torch.dtype):
        super().__init__()
        self.layers_0 = DepthwiseConv(emb_dim, 3, dtype)
        self.layers_1 = Dense(emb_dim, u_dim, dtype)
        self.layers_3 = DepthwiseConv(u_dim, 3, dtype)
        self.layers_4 = Dense(u_dim, u_dim, dtype)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """``sp``: each radius-1 conv reads its own 1-frame halo"""
        if sp is None:
            x = F.silu(self.layers_1(self.layers_0(x)))
            return F.silu(self.layers_4(self.layers_3(x)))
        x = F.silu(self.layers_1(self.layers_0(halo_exchange(x, 1, sp))[:, 1:-1]))
        return F.silu(self.layers_4(self.layers_3(halo_exchange(x, 1, sp))[:, 1:-1]))


class DiffusionModel(nn.Module):
    def __init__(self, args: DiffusionModelArgs, dtype: torch.dtype):
        super().__init__()
        a = args
        self.args = args
        self.audio_in = Dense(a.a_dim, a.a_dim, dtype)
        self.style_in = Dense(a.style_dim, a.global_cond_dim, dtype)
        self.proj_in = Dense(a.emb_dim, a.backbone_dim, dtype)
        self.net = Backbone(a.backbone_dim, a.a_dim, a.global_cond_dim, a.backbone, dtype)
        self.proj_out = Dense(a.backbone_dim, a.emb_dim, dtype, zero_init=True)
        self.u_convs = UConvs(a.emb_dim, a.u_head_dim, dtype)
        self.u_film = Dense(a.global_cond_dim, 2 * a.u_head_dim, dtype, zero_init=True)
        self.u_out = Dense(a.u_head_dim, 1, dtype, zero_init=True, bias_init=_U_BIAS_INIT)

    def init_params(self, generator: torch.Generator) -> "DiffusionModel":
        """flax's initialisation of ``DiffusionModel.init``: lecun_normal
        kernels, zero biases, zero FiLM/proj_out/u_film/u_out kernels, the
        u_out bias at -0.4328, unit q/k gains; drawn from ``generator`` in
        module order"""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def forward(self, audio: torch.Tensor, style: torch.Tensor, xt: torch.Tensor,
                train: bool = False, sp=None) -> tuple[torch.Tensor, torch.Tensor]:
        """the training call: -> (u (B,) f32, v (B, l, E)). ``train`` only
        guards dropout, which is not ported: with backbone.dropout > 0 a
        training call raises (at dropout 0 both modes compute the same)"""
        if train and self.args.backbone.dropout > 0:
            raise NotImplementedError("training with backbone.dropout > 0 is not ported")
        return self.predict(*self.precompute_cond(audio, style), xt, sp)

    def precompute_cond(self, audio: torch.Tensor, style: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """project the conditioning once per sample"""
        return F.silu(self.audio_in(audio)), F.silu(self.style_in(style))

    def predict(self, audio_c: torch.Tensor, cond_g: torch.Tensor, xt: torch.Tensor,
                sp=None) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (u (B,) f32, v (B, l, E))"""
        h = self.net(self.proj_in(xt), audio_c, cond_g, sp)
        v = self.proj_out(h)
        f = self.u_convs(xt, sp).mean(dim=1)
        if sp is not None:  # the global time mean on every rank
            f = all_reduce_sum(f, sp) / group_size(sp)
        scale, shift = self.u_film(cond_g).chunk(2, dim=-1)
        f = f * (1 + scale) + shift
        u = self.args.u_scale * F.softplus(self.u_out(f).float())[:, 0]
        return u, v

    def sample(
        self,
        audio: torch.Tensor,   # (#B, l, A)
        style: torch.Tensor,   # (B, S)
        num_steps: int,
        x0: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        sp=None,
        batch_mean=None,
    ) -> torch.Tensor:
        """sphere tracing from ``x0`` (drawn N(0, 1) from ``generator`` when
        not given). eta stays a device tensor and the loop is a fixed Python
        loop, so sampling never waits on the host; x stays f32. With ``sp``,
        ``audio`` is this rank's span and ``x0`` the GLOBAL noise (B, l x
        ranks, E), drawn or given, of which the rank takes its span: the
        sharded sampler equals the unsharded one for the same noise.
        ``batch_mean`` (default the tensor's mean) takes the step-size
        calibration's mean over the rows, as in the style prior's sampler."""
        if audio.dim() != 3 or audio.shape[-1] != self.args.a_dim:
            raise ValueError(f"audio must be (#B, l, {self.args.a_dim}), got {tuple(audio.shape)}")
        if style.shape[-1] != self.args.style_dim:
            raise ValueError(f"bad style shape {tuple(style.shape)}")
        B, l = style.shape[0], audio.shape[1]
        if x0 is None:
            x0 = torch.randn(B, l * group_size(sp), self.args.emb_dim, generator=generator,
                             device=audio.device)
        if sp is not None:
            x0 = x0[:, group_rank(sp) * l:(group_rank(sp) + 1) * l]
        audio_c, cond_g = self.precompute_cond(audio, style)
        sqrt_c0 = sqrt(self.args.c0)
        u = self.predict(audio_c, cond_g, x0, sp)[0]
        u0 = u.mean() if batch_mean is None else batch_mean(u)
        eta = 1.0 - (sqrt_c0 / u0.clamp_min(sqrt_c0 + 1e-6)) ** (1.0 / num_steps)
        x = x0
        for _ in range(num_steps):
            u, v = self.predict(audio_c, cond_g, x, sp)
            x = x - eta * u[:, None, None] * v.float()
        return x
