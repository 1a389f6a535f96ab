"""Train state: parameters, optimizer, EMA, the latent stage's loss EMA and
the step's random generator.

Counterpart of osu_dreamer_tpu/train/state.py. The optimizer keeps optax's
semantics, not torch's defaults: ``optax.chain(clip_by_global_norm(clip),
adamw(schedule, weight_decay))``:
- the gradients are scaled by ``clip / norm`` only when ``norm >= clip``
  (``torch.nn.utils.clip_grad_norm_`` would add 1e-6 to the norm);
- Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
  correction at the incremented count;
- weight decay on every parameter, added to the Adam update;
- the learning rate read from the schedule at the count BEFORE the update.
JAX's state is immutable; here the parameters, moments and EMA are updated
in place (with ``torch._foreach_*`` ops, a few launches per update).

A tensor-parallel model (parallel/tp.py) holds its rank's slices; its
``state_dict`` gathers the whole tensors (a collective over the model group)
and ``load_state_dict`` slices them, so checkpoints keep the one-process
layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..nn.schedule import LRScheduleArgs, make_lr_schedule
from ..parallel.tp import layout_of
from .profiling import span


@dataclass
class OptimizerArgs:
    lr: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: LRScheduleArgs = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = LRScheduleArgs()


class AdamW:
    """``clip_by_global_norm`` + ``adamw`` (optax) over a fixed list of
    parameters, updated in place"""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: list[torch.Tensor], args: OptimizerArgs):
        self.params = params
        self.args = args
        self.schedule = make_lr_schedule(args.lr, args.schedule)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    @span("train.optimizer")
    def step(self, grads: list[torch.Tensor], norm: torch.Tensor | None = None) -> torch.Tensor:
        """apply one update from ``grads`` (one per parameter, same order),
        clipped by ``norm`` (by default theirs: a tensor-parallel rank passes
        the whole model's); -> the global gradient norm before clipping (a
        device scalar)"""
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = self.args.grad_clip
        # optax: g where norm < clip, else g / norm * clip
        scale = torch.where(norm < clip, torch.ones_like(norm), clip / norm)
        grads = torch._foreach_mul(grads, scale)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        lr = float(self.schedule(self.count))
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.args.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
                dst.copy_(src)


def make_optimizer(params: list[torch.Tensor], args: OptimizerArgs) -> AdamW:
    """the JAX package's ``make_optimizer`` over ``params``"""
    return AdamW(params, args)


@torch.no_grad()
@span("train.ema")
def ema_update(ema: nn.Module, model: nn.Module, decay: float = 0.99) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place"""
    e, p = list(ema.parameters()), list(model.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, p, alpha=1.0 - decay)


@dataclass
class TrainState:
    """the model (its parameters are the training parameters, f32), the
    optimizer, an EMA copy of the model (denoiser and style; None for the
    latent stage), the generator the steps draw their randomness from, and
    the latent stage's per-component loss EMA with its ready flag (device
    tensors, updated without a host sync; None elsewhere)"""

    step: int
    model: nn.Module
    opt: AdamW
    ema_model: nn.Module | None
    generator: torch.Generator
    loss_ema: torch.Tensor | None = None
    loss_ema_ready: torch.Tensor | None = None

    def state_dict(self) -> dict:
        """the state in the one-process layout (under tensor parallelism a
        collective: every rank of the model group calls it)"""
        state = {
            "step": self.step,
            "params": self.model.state_dict(),
            "opt": self.opt.state_dict(),
            "ema_params": None if self.ema_model is None else self.ema_model.state_dict(),
            "generator": self.generator.get_state(),
            "loss_ema": self.loss_ema,
            "loss_ema_ready": self.loss_ema_ready,
        }
        layout = layout_of(self.model)
        return state if layout is None else layout.gather_state(state)

    def load_state_dict(self, state: dict) -> None:
        layout = layout_of(self.model)
        if layout is not None:
            state = layout.scatter_state(state)
        self.step = int(state["step"])
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt"])
        if self.ema_model is not None:
            self.ema_model.load_state_dict(state["ema_params"])
        self.generator.set_state(state["generator"])
        with torch.no_grad():
            for name in ("loss_ema", "loss_ema_ready"):
                if getattr(self, name) is not None:
                    getattr(self, name).copy_(state[name])


def stratified_logit_normal_t(n: int, generator: torch.Generator,
                              device: torch.device | str) -> torch.Tensor:
    """stratified logit-normal interpolation times: permuted strata plus
    in-stratum jitter through the normal quantile and a sigmoid"""
    strata = torch.randperm(n, generator=generator, device=device).float()
    u = (strata + torch.rand(n, generator=generator, device=device)) / n
    return torch.sigmoid(torch.special.ndtri(u.clamp(1e-6, 1.0 - 1e-6)))
