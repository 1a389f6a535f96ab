"""Stage-2 training step for the latent denoiser.

Counterpart of osu_dreamer_tpu/models/diffusion/train.py: the per-frame
metric ``frame_dist_sq`` (channel sum, length mean), stratified logit-normal
interpolation times, the distance-marching losses (inverse-distance weighted
one-step denoising ``osl`` and the directional eikonal ``del``, weights 1 and
30) with the ``u_mape`` metric, AdamW with optax's semantics and an EMA copy
of the parameters updated every step. ``t`` and ``x0`` are drawn from the
state's generator unless given (the parity tests inject them drawn the JAX
way).

Parallel steps (``par``, parallel/config.py): ``t`` and ``x0`` are made at
the GLOBAL shape (the global batch, the global window length) and each rank
takes its rows and its span, so every rank draws the same from its identical
generator and a parallel step equals the single-process step on the global
batch. Under sequence parallelism the length means are all-reduced over the
sp group (with a backward), the per-rank batch means are averaged over the
data ranks for the metrics, and the gradients over all ranks. Under tensor
parallelism a rank holds its slices of the attention and FFN modules
(parallel/tp.py): a model group's ranks take the same rows and draws, the
gradients are averaged over the data group, and the clip reads the whole
model's norm.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ...nn.blocks import shard_tensor_parallel
from ...parallel.collectives import all_reduce_sum, group_size
from ...parallel.tp import layout_of
from ...train.profiling import span
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


def frame_dist_sq(a: torch.Tensor, b: torch.Tensor, sp=None) -> torch.Tensor:
    """squared distance in the per-frame metric: channel sum, length mean.
    ``sp``: the length is sharded over that group; the local mean is
    all-reduced so every rank carries the global value"""
    d = (a - b).float()
    r = (d * d).sum(-1).mean(-1)
    if sp is not None:
        r = all_reduce_sum(r, sp) / group_size(sp)
    return r


def diffusion_loss(
    model: DiffusionModel,
    batch: LatentBatch,
    args: DiffusionTrainArgs,
    generator: torch.Generator | None = None,
    t: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    train: bool = True,
    par=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """-> (loss, {"loss", "osl", "del", "u_mape"}) over this rank's rows;
    ``t`` (B,) and ``x0`` (B, l, E), at the global batch and length under
    ``par``, are drawn from ``generator`` unless given"""
    B, l, E = batch.z.shape
    dev = batch.z.device
    n_data, sp = (par.n_data, par.sp_group) if par is not None else (1, None)
    if t is None:
        t = stratified_logit_normal_t(B * n_data, generator, dev)
    if x0 is None:
        x0 = torch.randn(B * n_data, l * group_size(sp), E, generator=generator, device=dev)
    if par is not None:
        t, x0 = par.take_rows(t, B), par.take_span(par.take_rows(x0, B), l)
    x1 = batch.z.float()
    xt = x0 + t[:, None, None] * (x1 - x0)

    u_pred, v_pred = model(batch.h, batch.s, xt, train=train, sp=sp)

    c0 = model.args.c0
    d_sq = frame_dist_sq(xt, x1, sp)
    u_target = torch.sqrt(d_sq + c0)
    denoised = xt - u_pred[:, None, None] * v_pred.float()
    osl = (frame_dist_sq(denoised, x1, sp) / (d_sq + c0)).mean()
    v_target = (xt - x1) / u_target[:, None, None]
    del_ = frame_dist_sq(v_pred, v_target, sp).mean()
    loss = args.osl_weight * osl + args.del_weight * del_
    u_mape = ((u_pred - u_target).abs() / u_target).mean()
    return loss, {"loss": loss, "osl": osl, "del": del_, "u_mape": u_mape}


def step_gradients(model: DiffusionModel, batch: LatentBatch, args: DiffusionTrainArgs,
                   generator: torch.Generator | None = None, t=None, x0=None, par=None
                   ) -> tuple[dict[str, torch.Tensor], list[torch.Tensor]]:
    """one step's metrics (averaged over the data ranks) and parameter
    gradients (averaged over the ranks, parallel/config.py
    ``average_gradients``) -> (metrics, gradients)"""
    with span("train.loss"):
        loss, aux = diffusion_loss(model, batch, args, generator, t, x0, par=par)
    with span("train.grad"):
        grads = list(torch.autograd.grad(loss, list(model.parameters())))
    if par is None:
        return {k: v.detach() for k, v in aux.items()}, grads
    return par.mean_over_data(aux), par.average_gradients(grads, layout_of(model))


def make_train_step(args: DiffusionTrainArgs, par=None):
    """-> step(state, batch, t=None, x0=None) -> metrics: one update of the
    state in place (loss gradient, clip + AdamW, EMA, step + 1); under
    ``par`` ``batch`` is this rank's share and ``t``/``x0`` are global"""

    @span("train.step")
    def train_step(state: TrainState, batch: LatentBatch, t=None, x0=None) -> dict:
        metrics, grads = step_gradients(state.model, batch, args, state.generator, t, x0, par)
        state.opt.step(grads, par.grad_norm(grads, layout_of(state.model)) if par else None)
        ema_update(state.ema_model, state.model, args.ema_decay)
        state.step += 1
        return metrics

    return train_step


def init_diffusion_training(
    model_args: DiffusionModelArgs,
    train_args: DiffusionTrainArgs,
    seed: int,
    device: torch.device | str,
    dtype: torch.dtype,
    par=None,
):
    """-> (state, train_step). The parameters are drawn on the CPU from
    ``seed`` (flax's initialisation, the same on every device and rank; a
    tensor-parallel rank keeps its slices); the steps' generator lives on
    ``device``, seeded ``seed + 1``"""
    model = DiffusionModel(model_args, dtype).init_params(torch.Generator().manual_seed(seed))
    shard_tensor_parallel(model, par)
    model = model.to(device)
    ema = copy.deepcopy(model).requires_grad_(False)
    state = TrainState(
        step=0,
        model=model,
        opt=make_optimizer(list(model.parameters()), train_args.opt),
        ema_model=ema,
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )
    return state, make_train_step(train_args, par)
