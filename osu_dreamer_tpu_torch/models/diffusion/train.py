"""Stage-2 training step for the latent denoiser.

Counterpart of osu_dreamer_tpu/models/diffusion/train.py: the per-frame
metric ``frame_dist_sq`` (channel sum, length mean), stratified logit-normal
interpolation times, the distance-marching losses (inverse-distance weighted
one-step denoising ``osl`` and the directional eikonal ``del``, weights 1 and
30) with the ``u_mape`` metric, AdamW with optax's semantics and an EMA copy
of the parameters updated every step. ``t`` and ``x0`` are drawn from the
state's generator unless given (the parity tests inject them drawn the JAX
way).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ...train.state import (
    OptimizerArgs, TrainState, ema_update, make_optimizer, stratified_logit_normal_t,
)
from .model import DiffusionModel, DiffusionModelArgs


@dataclass
class DiffusionTrainArgs:
    opt: OptimizerArgs = field(default_factory=lambda: OptimizerArgs(lr=3e-4))
    osl_weight: float = 1.0
    del_weight: float = 30.0
    ema_decay: float = 0.99
    val_batches: int = 8


class LatentBatch(NamedTuple):
    """cached latent-space training batch, channel-last"""

    h: torch.Tensor       # (B, l, A) audio features at latent rate
    z: torch.Tensor       # (B, l, E) chart latents
    s: torch.Tensor       # (B, S) style codes
    labels: torch.Tensor  # (B, NUM_LABELS)


def frame_dist_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """squared distance in the per-frame metric: channel sum, length mean"""
    d = (a - b).float()
    return (d * d).sum(-1).mean(-1)


def diffusion_loss(
    model: DiffusionModel,
    batch: LatentBatch,
    args: DiffusionTrainArgs,
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    train: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """-> (loss, {"loss", "osl", "del", "u_mape"}); ``t`` (B,) and ``x0``
    (B, l, E) are drawn from ``generator`` unless given"""
    B, dev = batch.z.shape[0], batch.z.device
    if t is None:
        t = stratified_logit_normal_t(B, generator, dev)
    if x0 is None:
        x0 = torch.randn(batch.z.shape, generator=generator, device=dev)
    x1 = batch.z.float()
    xt = x0 + t[:, None, None] * (x1 - x0)

    u_pred, v_pred = model(batch.h, batch.s, xt, train=train)

    c0 = model.args.c0
    d_sq = frame_dist_sq(xt, x1)
    u_target = torch.sqrt(d_sq + c0)
    denoised = xt - u_pred[:, None, None] * v_pred.float()
    osl = (frame_dist_sq(denoised, x1) / (d_sq + c0)).mean()
    v_target = (xt - x1) / u_target[:, None, None]
    del_ = frame_dist_sq(v_pred, v_target).mean()
    loss = args.osl_weight * osl + args.del_weight * del_
    u_mape = ((u_pred - u_target).abs() / u_target).mean()
    return loss, {"loss": loss, "osl": osl, "del": del_, "u_mape": u_mape}


def make_train_step(args: DiffusionTrainArgs):
    """-> step(state, batch, t=None, x0=None) -> metrics: one update of the
    state in place (loss gradient, clip + AdamW, EMA, step + 1)"""

    def train_step(state: TrainState, batch: LatentBatch, t=None, x0=None) -> dict:
        params = list(state.model.parameters())
        loss, aux = diffusion_loss(state.model, batch, args, state.generator, t, x0)
        grads = torch.autograd.grad(loss, params)
        state.opt.step(list(grads))
        ema_update(state.ema_model, state.model, args.ema_decay)
        state.step += 1
        return {k: v.detach() for k, v in aux.items()}

    return train_step


def init_diffusion_training(
    model_args: DiffusionModelArgs,
    train_args: DiffusionTrainArgs,
    seed: int,
    device: torch.device | str,
    dtype: torch.dtype,
):
    """-> (state, train_step). The parameters are drawn on the CPU from
    ``seed`` (flax's initialisation, the same on every device); the steps'
    generator lives on ``device``, seeded ``seed + 1``"""
    model = DiffusionModel(model_args, dtype).init_params(torch.Generator().manual_seed(seed))
    model = model.to(device)
    ema = copy.deepcopy(model).requires_grad_(False)
    state = TrainState(
        step=0,
        model=model,
        opt=make_optimizer(list(model.parameters()), train_args.opt),
        ema_model=ema,
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )
    return state, make_train_step(train_args)
