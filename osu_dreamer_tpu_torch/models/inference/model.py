"""Composed three-stage inference pipeline.

Counterpart of osu_dreamer_tpu/models/inference/model.py (``LDM``): encode
the audio once, sample a style per (song, difficulty) row, sample latents by
sphere tracing, decode chart + labels with the audio skips.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from ...train.profiling import span
from ..diffusion.model import DiffusionModel, DiffusionModelArgs
from ..latent.model import LatentModel, LatentModelArgs
from ..style.model import StyleModel, StyleModelArgs


@dataclass
class LDMArgs:
    latent: LatentModelArgs = field(default_factory=LatentModelArgs)
    style: StyleModelArgs = field(default_factory=StyleModelArgs)
    diffusion: DiffusionModelArgs = field(default_factory=DiffusionModelArgs)


class LDM(nn.Module):
    def __init__(self, args: LDMArgs, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.args, self.dtype = args, dtype
        self.latent = LatentModel(args.latent, dtype)
        self.style = StyleModel(args.style, dtype)
        self.diffusion = DiffusionModel(args.diffusion, dtype)

    def forward(
        self,
        spec: torch.Tensor,     # (S, Lpad, A_DIM), chunk-padded
        labels: torch.Tensor,   # (D, 5) shared or (S, D, 5) per song
        num_steps: int,
        style_steps: int = 16,
        style_guidance: float = 1.0,
        s0: torch.Tensor | None = None,
        x0: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        batch_mean=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> ((S*D, Lpad, X_DIM) chart signal, (S*D, 5) predicted labels),
        rows song-major. S == 1 broadcasts the audio encoding over the D
        rows; S > 1 repeats it D times. ``s0`` (S*D, style_dim) and ``x0``
        (S*D, Lpad / chunk, emb_dim) inject the samplers' starting noise;
        otherwise it is drawn from ``generator``. ``batch_mean`` replaces the
        samplers' mean over the rows (a shard of a batch split over replicas
        takes the whole batch's)."""
        S = spec.shape[0]
        with span("latent.encode"):
            skips, h = self.latent.encode_audio(spec)
        per_song = labels.dim() == 3
        D = labels.shape[1] if per_song else labels.shape[0]
        if per_song:
            labels = labels.reshape(S * D, labels.shape[-1])
        elif S > 1:
            labels = labels.repeat(S, 1)
        if S > 1:
            h, *skips = (t[:, None].expand(S, D, *t.shape[1:]).reshape(S * D, *t.shape[1:])
                         for t in (h, *skips))
        with span("style.sample"):
            s = self.style.sample(labels, style_steps, style_guidance, s0=s0,
                                  generator=generator, batch_mean=batch_mean)
        with span("diffusion.sample"):
            z = self.diffusion.sample(h, s, num_steps, x0=x0, generator=generator,
                                      batch_mean=batch_mean)
        with span("latent.decode"):
            return self.latent.decode(z, s, skips=skips)
