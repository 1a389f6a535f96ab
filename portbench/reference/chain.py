"""The reference's two timed paths: a batch of mapsets from int16 waves,
and the first steps of denoiser training with AdamW and the EMA.

``mapset_batch`` follows one batch from the waves to the quantized chart:
spectrogram, audio encoder, style prior, denoiser sampler, decoder,
quantization. ``train_steps`` follows training from the drawn weights
through n steps on the given batches and noise, with the optimizer of
optax's ``chain(clip_by_global_norm, adamw)`` and an EMA of the weights.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as M
from .numerics import Numerics
from .spectrogram import spec_for_model

XY_RANGE, XY_SCALE = 4.0, 8191.0


def quantize(chart: torch.Tensor) -> np.ndarray:
    """(..., L, 9) chart -> the chart as the 8-bit hit and 16-bit fixed-point
    cursor channels carry it, back in float32"""
    hit = torch.round(chart[..., :M.HIT_DIM].clamp(0.0, 1.0) * 255.0) / 255.0
    xy = torch.round(chart[..., M.HIT_DIM:].clamp(-XY_RANGE, XY_RANGE) * XY_SCALE)
    xy = xy.clamp(-32768, 32767) / XY_SCALE
    return torch.cat([hit, xy], dim=-1).cpu().numpy()


@torch.no_grad()
def mapset_batch(P: dict, cfg: dict, waves_i16, real_frames, labels, s0, x0, n_frames: int,
                 out_frames: int, steps: int, style_steps: int, guidance: float,
                 nx: Numerics) -> tuple[np.ndarray, np.ndarray]:
    """waves (S, samples) int16, real_frames (S,), labels (S, D, 5), s0 (S D,
    style), x0 (S D, l, E) -> (quantized chart (S D, out_frames, 9), labels
    (S D, 5)), rows song-major. The encoder and the decoder run a song at a
    time, so that the full-length activations fit beside each other."""
    S, D = labels.shape[:2]
    spec = spec_for_model(waves_i16, real_frames, n_frames, out_frames)
    skips, h = [], []
    for i in range(S):  # the audio encoder, a song at a time
        sk, hi = M.encode_audio(P, cfg, spec[i:i + 1], nx)
        skips.append(sk)
        h.append(hi)
    song = torch.arange(S * D, device=h[0].device) // D
    h = torch.cat(h)[song]
    s = M.style_sample(P, cfg, labels.reshape(S * D, -1).float(), s0.float(), style_steps,
                       guidance, nx)
    z = M.denoiser_sample(P, cfg, h, s, x0.float(), steps, nx)
    charts, out_labels = [], []
    for i in range(S):
        rows = slice(i * D, (i + 1) * D)
        chart, lab = M.decode(P, cfg, z[rows], s[rows], skips[i], nx)
        charts.append(quantize(chart))
        out_labels.append(lab.cpu().numpy())
    return np.concatenate(charts), np.concatenate(out_labels)


class AdamW:
    """clip by the global norm (scale only at or above the clip), Adam with
    bias correction at the incremented count, decoupled weight decay added
    to the update, the learning rate read at the count before the update"""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, opt: dict):
        self.params, self.opt = params, opt
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def lr(self, step: int) -> float:
        sch, f32 = self.opt["schedule"], np.float32
        warm = max(sch["warmup_steps"], 1)
        if step < warm:
            mult = f32(sch["warmup_init"]) ** max(f32(0.0), f32(1.0) - f32(step) / f32(warm))
        elif step > sch["decay_start"]:
            mult = math.sqrt(sch["decay_start"] / max(step, 1))
        else:
            mult = 1.0
        return float(f32(self.opt["lr"]) * f32(mult))

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """-> the clipped gradients the moments took"""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        clip = self.opt["grad_clip"]
        scale = 1.0 if float(norm) < clip else clip / float(norm)
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.sub_(lr * (update + self.opt["weight_decay"] * p))
        return clipped


def train_steps(P0: dict, cfg: dict, batches: list, noise: list, nx: Numerics,
                rows: slice | None = None) -> dict:
    """n steps from the weights ``P0`` (left as they are) on ``batches``
    ((h, z, s) each) with ``noise`` ((t, x0) each). ``rows`` keeps only those
    rows of each batch (a fault the checks must catch). -> {"loss": [n
    floats], "grad": the first step's clipped gradients, "params": the
    weights after n steps, "ema": the EMA after n steps}"""
    tr = cfg["train"]
    P = {k: v.detach().clone().float() for k, v in P0.items()}
    ema = {k: v.clone() for k, v in P.items()}
    opt = AdamW(P, tr["opt"])
    losses, first = [], None
    for (h, z, s), (t, x0) in zip(batches, noise):
        if rows is not None:
            h, z, s, t, x0 = (a[rows] for a in (h, z, s, t, x0))
        leaves = {k: v.requires_grad_() for k, v in P.items()}
        loss = M.denoiser_loss(leaves, cfg, h.float(), z.float(), s.float(), t.float(),
                               x0.float(), nx, tr["osl_weight"], tr["del_weight"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for v in P.values():
            v.requires_grad_(False)
        clipped = opt.step(grads)
        first = clipped if first is None else first
        with torch.no_grad():
            for k in ema:
                ema[k].mul_(tr["ema_decay"]).add_(P[k], alpha=1.0 - tr["ema_decay"])
        losses.append(float(loss.detach()))
    return {"loss": losses, "grad": first, "params": P, "ema": ema}
