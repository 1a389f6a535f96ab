"""Stage-1 chart autoencoder (WAE): chart signal -> latent z + style s, and
back, given the audio.

Counterpart of osu_dreamer_tpu/models/latent/model.py: the audio stem
(``SpecFeatures``) and audio U-Net encoder with its skips, the chart encoder
(``encode_chart``: ``chart_stem``, ``chart_encoder``, ``style_stack``,
``style_pool``, ``temporal_stack``, ``temporal_proj``), the decoder that turns
z and s into chart logits and the 5 labels, and the training forward.
``init_params`` draws flax's initialisation of ``LatentModel.init``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ...audio.constants import A_DIM
from ...nn.blocks import MLP, Dense, DepthwiseConv, FilmStack, lecun_normal_
from ...nn.norm import RMSNorm, rms_norm
from ...nn.pool import AttnPool
from ...signal.constants import HIT_DIM, NUM_LABELS, X_DIM


@dataclass
class StackArgs:
    n_layers: int = 8
    expand: int = 4
    radius: int = 2


@dataclass
class LatentModelArgs:
    emb_dim: int = 6
    style_dim: int = 32
    n_downs: int = 3
    stride: int = 3
    h_dim: int = 128
    stack: StackArgs = field(default_factory=StackArgs)
    style_head_dim: int = 64
    style_heads: int = 16

    @property
    def chunk_size(self) -> int:
        return self.stride**self.n_downs


def _stack(dim: int, cond_dim: int, args: StackArgs, dtype: torch.dtype) -> FilmStack:
    return FilmStack(dim, cond_dim, args.n_layers, args.expand, args.radius, dtype)


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over (time, freq) with a bias; the kernel is held in
    torch's (out, in, kh, kw) layout (the weight bridge transposes flax's
    (kh, kw, in, out))"""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int], stride: tuple[int, int],
                 dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.stride, self.dtype = stride, dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax ``nn.Conv``: lecun_normal with fan_in = kh * kw * in, zero bias"""
        with torch.no_grad():
            lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, W, C_in) channel-last -> (B, L, W', C_out), padding 1 on
        both spatial axes"""
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.kernel.to(dt), stride=self.stride,
                     padding=(1, 1))
        return y.permute(0, 2, 3, 1) + self.bias.to(dt)


def _conv_width(w: int, k: int, s: int) -> int:
    return (w + 2 - k) // s + 1


class SpecFeatures(nn.Module):
    """audio stem: (B, L, 72) -> (B, L, h_dim) via two strided 2-D convs over
    (time, freq); the flatten after ``c2`` is in (freq, channel) order"""

    def __init__(self, h_dim: int, dtype: torch.dtype):
        super().__init__()
        self.c1 = Conv2d(1, 8, (3, 8), (1, 6), dtype)
        self.n1 = RMSNorm(8)
        self.c2 = Conv2d(8, 32, (3, 6), (1, 4), dtype)
        self.n2 = RMSNorm(32)
        width = _conv_width(_conv_width(A_DIM, 8, 6), 6, 4)
        self.proj = Dense(width * 32, h_dim, dtype)
        self.n3 = RMSNorm(h_dim)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.n1(self.c1(spec[..., None])))
        x = F.silu(self.n2(self.c2(x)))
        B, L = x.shape[:2]
        return F.silu(self.n3(self.proj(x.reshape(B, L, -1))))


class Downsample(nn.Module):
    """depthwise antialias conv + mean-pool by ``stride``"""

    def __init__(self, dim: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.dw = DepthwiseConv(dim, 1 + 2 * (stride // 2), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw(x)
        B, L, C = x.shape
        return x.reshape(B, L // self.stride, self.stride, C).mean(dim=2)


class Upsample(nn.Module):
    """nearest repeat by ``stride`` + depthwise smoothing conv"""

    def __init__(self, dim: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.dw = DepthwiseConv(dim, 1 + 2 * (stride // 2), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dw(x.repeat_interleave(self.stride, dim=1))


class SkipMixer(nn.Module):
    """inject an encoder skip: x + norm(proj(skip)) * gate(x), the gate
    zero-initialised (kernel and bias)"""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Dense(dim, dim, dtype)
        self.norm = RMSNorm(dim)
        self.gate = Dense(dim, dim, dtype, zero_init=True)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x + self.norm(self.proj(skip)) * self.gate(x)


class UNetEncoder(nn.Module):
    """n_downs x [stack -> skip -> downsample]; -> (skips, bottom)"""

    def __init__(self, dim: int, n_downs: int, stride: int, stack: StackArgs, dtype: torch.dtype):
        super().__init__()
        self.n_downs = n_downs
        for i in range(n_downs):
            self.add_module(f"stack{i}", _stack(dim, 0, stack, dtype))
            self.add_module(f"down{i}", Downsample(dim, stride, dtype))

    def forward(self, x: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        skips = []
        for i in range(self.n_downs):
            x = getattr(self, f"stack{i}")(x)
            skips.append(x)
            x = getattr(self, f"down{i}")(x)
        return skips, x


class UNetDecoder(nn.Module):
    """n_downs x [upsample -> mix skip -> FiLM(style) stack]"""

    def __init__(self, dim: int, cond_dim: int, n_downs: int, stride: int, stack: StackArgs,
                 dtype: torch.dtype):
        super().__init__()
        self.n_downs = n_downs
        for i in range(n_downs):
            self.add_module(f"up{i}", Upsample(dim, stride, dtype))
            self.add_module(f"mix{i}", SkipMixer(dim, dtype))
            self.add_module(f"stack{i}", _stack(dim, cond_dim, stack, dtype))

    def forward(self, skips: list[torch.Tensor], x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_downs):
            x = getattr(self, f"up{i}")(x)
            skip = skips[-(i + 1)]
            skip = skip.expand(x.shape[0], *skip.shape[1:])
            x = getattr(self, f"mix{i}")(skip, x)
            x = getattr(self, f"stack{i}")(x, cond)
        return x


class LatentModel(nn.Module):
    """the full chart WAE"""

    def __init__(self, args: LatentModelArgs, dtype: torch.dtype):
        super().__init__()
        a = args
        self.args = args
        self.chart_stem = Dense(X_DIM, a.h_dim, dtype)
        self.chart_encoder = UNetEncoder(a.h_dim, a.n_downs, a.stride, a.stack, dtype)
        self.spec_stem = SpecFeatures(a.h_dim, dtype)
        self.audio_unet = UNetEncoder(a.h_dim, a.n_downs, a.stride, a.stack, dtype)
        self.style_stack = _stack(a.h_dim, 0, a.stack, dtype)
        self.style_pool = AttnPool(a.h_dim, a.style_dim, a.style_head_dim, a.style_heads, dtype)
        self.temporal_stack = _stack(a.h_dim, a.style_dim, a.stack, dtype)
        self.temporal_proj = Dense(a.h_dim, a.emb_dim, dtype)
        self.emb_proj = Dense(a.emb_dim, a.h_dim, dtype)
        self.decoder = UNetDecoder(a.h_dim, a.style_dim, a.n_downs, a.stride, a.stack, dtype)
        self.head = Dense(a.h_dim, X_DIM, dtype)
        self.label_mlp = MLP(a.style_dim, a.h_dim, NUM_LABELS, dtype)

    def init_params(self, generator: torch.Generator) -> "LatentModel":
        """flax's initialisation of ``LatentModel.init``: lecun_normal kernels
        (flax's fans), zero biases, zero FiLM and skip-gate layers, unit
        gains, block-norm gains 1e-3; drawn from ``generator`` in module
        order"""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def _check_len(self, t: torch.Tensor, name: str, width: int) -> None:
        if t.dim() != 3 or t.shape[-1] != width:
            raise ValueError(f"{name} must be (B, L, {width}), got {tuple(t.shape)}")
        if t.shape[1] % self.args.chunk_size:
            raise ValueError(f"L={t.shape[1]} must be a multiple of {self.args.chunk_size}")

    def encode_chart(self, chart: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, L, 9) -> z (B, L / chunk, emb_dim), s (B, style_dim); both RMS
        normalised (per frame, per map)"""
        self._check_len(chart, "chart", X_DIM)
        _, bottom = self.chart_encoder(self.chart_stem(chart))
        s = rms_norm(self.style_pool(self.style_stack(bottom)))
        z = rms_norm(self.temporal_proj(self.temporal_stack(bottom, s)))
        return z, s

    def encode_audio(self, spec: torch.Tensor) -> tuple[list[torch.Tensor], torch.Tensor]:
        """(B, L, 72) -> (skips, h (B, L / chunk, h_dim))"""
        self._check_len(spec, "spec", A_DIM)
        return self.audio_unet(self.spec_stem(spec))

    def decode_logits(self, z: torch.Tensor, s: torch.Tensor, *, spec: torch.Tensor | None = None,
                      skips: list[torch.Tensor] | None = None) -> torch.Tensor:
        """chart logits from z and s, given the audio as ``spec`` or as the
        audio encoder's ``skips``"""
        if skips is None:
            if spec is None:
                raise ValueError("decode needs spec or skips")
            skips, _ = self.encode_audio(spec)
        return self.head(self.decoder(skips, self.emb_proj(z), s))

    def predict_labels(self, s: torch.Tensor) -> torch.Tensor:
        return self.label_mlp(s)

    def decode(self, z: torch.Tensor, s: torch.Tensor, *, spec: torch.Tensor | None = None,
               skips: list[torch.Tensor] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (chart signal with sigmoided hit channels, labels in [0, 10])"""
        logits = self.decode_logits(z, s, spec=spec, skips=skips)
        chart = torch.cat([logits[..., :HIT_DIM].sigmoid(), logits[..., HIT_DIM:]], dim=-1)
        return chart, self.predict_labels(s).clamp(0.0, 10.0)

    def forward(self, spec: torch.Tensor, z: torch.Tensor, s: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """training forward: -> (chart logits, label predictions)"""
        return self.decode_logits(z, s, spec=spec), self.predict_labels(s)
