"""Stage-1 training step for the chart WAE.

Counterpart of osu_dreamer_tpu/models/latent/train.py:
- each window is halved into two batch items whose style codes are SWAPPED
  before decoding, so reconstruction itself enforces style consistency;
- WAE-MMD pull of s towards N(0, I) (weight 1e-3);
- train-only z/s gaussian noise, s -> prior-sample masking, and a zeroed
  contiguous z-span per item;
- losses: per-channel hit BCE minus the soft-target entropy floor, cursor MSE
  on 0th/1st/2nd temporal differences, label MSE excluding s-masked rows;
- fixed component weights (label 6) normalised by a 0.01-EMA of each
  component held in the TrainState (the raw components on the first step).

The loss's seven draws (prior normal, s noise, z noise, s-mask uniform,
s replacement normal, span uniform, start uniform) come from the state's
generator unless given as ``LatentDraws`` (the parity tests draw them the
JAX way).

Data-parallel steps (``par``): the draws are made at the global batch and
each rank takes its rows (the MMD's prior stays whole); the style codes are
gathered over the data ranks, so the MMD runs over the global batch as GSPMD
computes it in the JAX package, and the loss components are all-reduced into
their global values (the label loss as a global sum over a global count).
Every rank so holds the same loss; the gradients are averaged over the
ranks. The style swap stays local: a pair is the two halves of one window.
Under tensor parallelism (parallel/tp.py) a rank holds its slices of the
FilmStacks' FFNs, a model group's ranks take the same rows and draws, the
gathers and sums above run over the data group, the gradients are averaged
over it, and the clip reads the whole model's norm.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ...nn.blocks import shard_tensor_parallel
from ...nn.mmd import mmd_imq
from ...parallel.collectives import all_gather_rows, all_reduce_sum
from ...parallel.tp import layout_of
from ...signal.constants import HIT_DIM
from ...train.profiling import span
from ...train.state import OptimizerArgs, TrainState, make_optimizer
from .model import LatentModel, LatentModelArgs

LOSS_COMPONENTS = (
    "hit/onset", "hit/combo", "hit/slide", "hit/sustain",
    "hit/whistle", "hit/finish", "hit/clap",
    "cursor/pos", "cursor/vel", "cursor/acc",
    "label",
)
# hit channels x7, cursor pos/vel/acc, label (raised from the upstream's 2,
# as in the JAX package)
LOSS_WEIGHTS = np.array([1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 6], np.float32)


@dataclass
class LatentTrainArgs:
    opt: OptimizerArgs = field(default_factory=OptimizerArgs)
    s_reg_weight: float = 1e-3
    s_noise: float = 0.2
    z_noise: float = 0.2
    s_mask_frac: float = 0.1
    z_mask_frac: float = 0.25


class Batch(NamedTuple):
    """one training batch, channel-last"""

    audio: torch.Tensor   # (B, L, A_DIM)
    chart: torch.Tensor   # (B, L, X_DIM)
    labels: torch.Tensor  # (B, NUM_LABELS)


class LatentDraws(NamedTuple):
    """the loss's random draws for 2B items of style width S and l latents"""

    prior: torch.Tensor    # (2B, S) normal, the MMD's prior sample
    s_noise: torch.Tensor  # (2B, S) normal
    z_noise: torch.Tensor  # (2B, l, E) normal
    s_mask: torch.Tensor   # (2B,) uniform
    s_repl: torch.Tensor   # (2B, S) normal
    span: torch.Tensor     # (2B,) uniform
    start: torch.Tensor    # (2B,) uniform


def draw_latent(n: int, s_dim: int, l: int, e_dim: int, generator: torch.Generator,
                device: torch.device | str) -> LatentDraws:
    """the seven f32 draws from ``generator``, in the JAX loss's order"""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return LatentDraws(normal(n, s_dim), normal(n, s_dim), normal(n, l, e_dim), uniform(n),
                       normal(n, s_dim), uniform(n), uniform(n))


def _split_halves(x: torch.Tensor) -> torch.Tensor:
    """(B, L, C) -> (2B, L/2, C): window halves become separate items"""
    B, L, C = x.shape
    return x.reshape(B * 2, L // 2, C)


def _swap_style_pairs(s: torch.Tensor) -> torch.Tensor:
    """(2B, S) -> style codes exchanged within each adjacent pair"""
    S = s.shape[-1]
    return s.reshape(-1, 2, S).flip(1).reshape(-1, S)


def _binary_entropy(t: torch.Tensor) -> torch.Tensor:
    """soft-target BCE floor: H(t) = -t log t - (1-t) log(1-t)"""
    return -(torch.special.xlogy(t, t) + torch.special.xlogy(1 - t, 1 - t))


def _diff(x: torch.Tensor, n: int) -> torch.Tensor:
    return x if n == 0 else torch.diff(x, n=n, dim=1)


def latent_loss(
    model: LatentModel,
    batch: Batch,
    args: LatentTrainArgs,
    generator: torch.Generator | None = None,
    train: bool = True,
    draws: LatentDraws | None = None,
    par=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], torch.Tensor]:
    """-> (loss components (11,), aux metrics, s_reg loss); under ``par``
    ``batch`` is this rank's rows and ``draws`` are at the global batch"""
    audio = _split_halves(batch.audio)
    chart = _split_halves(batch.chart)
    labels = batch.labels.repeat_interleave(2, dim=0)
    B2 = chart.shape[0]
    group = par.data_group if par is not None else None
    n_data = par.n_data if par is not None else 1

    z, s = model.encode_chart(chart)
    if draws is None:
        draws = draw_latent(B2 * n_data, s.shape[-1], z.shape[1], z.shape[2], generator,
                            chart.device)

    s_reg = mmd_imq(all_gather_rows(s.float(), group), draws.prior)
    if par is not None:
        draws = draws._replace(**{k: par.take_rows(getattr(draws, k), B2)
                                  for k in LatentDraws._fields if k != "prior"})
    s = _swap_style_pairs(s)

    s_masked = torch.zeros(B2, dtype=torch.bool, device=chart.device)
    if train:
        s = s + args.s_noise * draws.s_noise.to(s.dtype)
        z = z + args.z_noise * draws.z_noise.to(z.dtype)
        if args.s_mask_frac > 0:
            s_masked = draws.s_mask < args.s_mask_frac
            s = torch.where(s_masked[:, None], draws.s_repl.to(s.dtype), s)
        if args.z_mask_frac > 0:
            # zero a random contiguous span of z per item (the casts truncate
            # toward zero, as .astype(int32) does)
            l = z.shape[1]
            span = (draws.span * args.z_mask_frac * l).to(torch.int32)
            start = (draws.start * (l - span).clamp_min(1).float()).to(torch.int32)
            idx = torch.arange(l, device=z.device)[None, :]
            in_span = (idx >= start[:, None]) & (idx < (start + span)[:, None])
            z = torch.where(in_span[:, :, None], torch.zeros((), dtype=z.dtype, device=z.device), z)

    logits, pred_labels = model(audio, z, s)

    # hit channels: BCE minus its soft-target floor, per channel
    true_hits = chart[..., :HIT_DIM].float()
    hit_logits = logits[..., :HIT_DIM].float()
    bce = (hit_logits.clamp_min(0) - hit_logits * true_hits
           + torch.log1p(torch.exp(-hit_logits.abs())))
    hit_losses = (bce - _binary_entropy(true_hits)).mean(dim=(0, 1))  # (7,)

    # cursor: MSE on position / velocity / acceleration
    true_xy = chart[..., HIT_DIM:].float()
    pred_xy = logits[..., HIT_DIM:].float()
    cursor_losses = [((_diff(pred_xy, n) - _diff(true_xy, n)) ** 2).mean() for n in range(3)]

    # labels, skipping rows whose style was replaced by a prior sample
    label_err = ((pred_labels.float() - labels) ** 2).mean(dim=1)
    kept = ~s_masked
    label_sum, label_count = torch.where(kept, label_err, 0.0).sum(), kept.sum().float()
    if group is not None:
        # the global means of the data ranks' equal shares; the label loss
        # over the global count of kept rows
        local = torch.stack([*hit_losses, *cursor_losses, label_sum, label_count])
        total = all_reduce_sum(local, group)
        hit_losses, cursor_losses = total[:7] / n_data, total[7:10] / n_data
        label_sum, label_count = total[10], total[11]
    label_loss = label_sum / label_count.clamp_min(1)

    components = torch.stack([*hit_losses, *cursor_losses, label_loss])
    aux = {name: components[i] for i, name in enumerate(LOSS_COMPONENTS)}
    aux["s_reg"] = s_reg
    return components, aux, s_reg


@functools.cache
def _loss_weights(device: torch.device) -> torch.Tensor:
    """LOSS_WEIGHTS on ``device``, copied there once"""
    return torch.from_numpy(LOSS_WEIGHTS).to(device)


def step_gradients(state: TrainState, batch: Batch, args: LatentTrainArgs,
                   draws: LatentDraws | None = None, par=None
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor], list[torch.Tensor]]:
    """one step's loss components (detached), metrics and parameter
    gradients (averaged over the ranks under ``par``), each component
    normalised by its running magnitude in the state (the raw components on
    the first step) -> (components, metrics, gradients)"""
    params = list(state.model.parameters())
    with span("train.loss"):
        components, aux, s_reg = latent_loss(state.model, batch, args, state.generator, True,
                                             draws, par)
    detached = components.detach()
    ema = torch.where(state.loss_ema_ready, state.loss_ema, detached)
    total = (_loss_weights(detached.device) * components / ema.clamp_min(1e-8)).sum()
    total = total + args.s_reg_weight * s_reg
    aux["loss"] = total
    # the audio encoder's last downsample feeds only encode-latents' h: its
    # gradient is zero, as JAX's
    with span("train.grad"):
        grads = list(torch.autograd.grad(total, params, materialize_grads=True))
    if par is not None:
        grads = par.average_gradients(grads, layout_of(state.model))
    return detached, {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(args: LatentTrainArgs, par=None):
    """-> step(state, batch, draws=None) -> metrics: one update of the state
    in place (loss gradient, clip + AdamW, loss EMA, step + 1); under ``par``
    ``batch`` is this rank's rows and ``draws`` are global"""

    @span("train.step")
    def train_step(state: TrainState, batch: Batch, draws: LatentDraws | None = None) -> dict:
        detached, metrics, grads = step_gradients(state, batch, args, draws, par)
        state.opt.step(grads, par.grad_norm(grads, layout_of(state.model)) if par else None)
        state.loss_ema = torch.where(state.loss_ema_ready,
                                     state.loss_ema * 0.99 + detached * 0.01, detached)
        state.loss_ema_ready = torch.ones_like(state.loss_ema_ready)
        state.step += 1
        return metrics

    return train_step


def init_latent_training(
    model_args: LatentModelArgs,
    train_args: LatentTrainArgs,
    seed: int,
    device: torch.device | str,
    dtype: torch.dtype,
    par=None,
):
    """-> (state, train_step). The parameters are drawn on the CPU from
    ``seed`` (flax's initialisation, the same on every rank); the steps'
    generator lives on ``device``, seeded ``seed + 1``; no EMA model; a
    tensor-parallel rank keeps its slices"""
    model = LatentModel(model_args, dtype).init_params(torch.Generator().manual_seed(seed))
    shard_tensor_parallel(model, par)
    model = model.to(device)
    state = TrainState(
        step=0,
        model=model,
        opt=make_optimizer(list(model.parameters()), train_args.opt),
        ema_model=None,
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        loss_ema=torch.ones(len(LOSS_COMPONENTS), device=device),
        loss_ema_ready=torch.zeros((), dtype=torch.bool, device=device),
    )
    return state, make_train_step(train_args, par)
