"""Learning-rate schedule: exponential warmup + inverse-sqrt decay.

Counterpart of osu_dreamer_tpu/nn/schedule.py. ``make_lr_schedule`` returns
a function of the step that computes in f32 as the JAX (optax) schedule
does, for the optimizer; ``lr_at`` is the same math in Python floats, for
logging.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(kw_only=True)
class LRScheduleArgs:
    warmup_steps: int = 0
    warmup_init: float = 1.0
    decay_start: float = float("inf")


def make_lr_schedule(base_lr: float, args: LRScheduleArgs):
    """-> step -> learning rate (an f32 scalar tensor on the CPU)"""
    if args.warmup_steps > args.decay_start:
        raise ValueError("warmup_steps must not exceed decay_start")
    f32 = torch.float32
    warmup_steps = torch.tensor(max(args.warmup_steps, 1), dtype=f32)
    warmup_init = torch.tensor(args.warmup_init, dtype=f32)
    decay_start = torch.tensor(args.decay_start, dtype=f32)
    lr = torch.tensor(base_lr, dtype=f32)

    def schedule(step: int) -> torch.Tensor:
        s = torch.tensor(step, dtype=f32)
        warm = warmup_init ** torch.clamp(1.0 - s / warmup_steps, min=0.0)
        decay = torch.where(s > decay_start, torch.sqrt(decay_start / torch.clamp(s, min=1.0)),
                            torch.ones((), dtype=f32))
        return lr * torch.where(s < warmup_steps, warm, decay)

    return schedule


def lr_at(step: int, base_lr: float, args: LRScheduleArgs) -> float:
    """host-side mirror of ``make_lr_schedule`` in plain floats"""
    warmup = max(args.warmup_steps, 1)
    if step < warmup:
        mult = args.warmup_init ** max(0.0, 1.0 - step / warmup)
    elif step > args.decay_start:
        mult = math.sqrt(args.decay_start / max(step, 1))
    else:
        mult = 1.0
    return base_lr * mult
