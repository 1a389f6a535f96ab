"""Random weights for a model, drawn on the device from the seed.

One normal draw covers every parameter; each takes its slice, scaled by its
kind: a kernel (two or more axes) by 1 / sqrt(its fan-in), a norm gain
(``*gamma``) as 1 + 0.1 N, any other vector as 0.1 N. Unlike the models'
own initialisation, nothing is zero: the FiLM gates, output projections
and distance heads that start at zero would leave most of the model out of
the output and of the gradients.
"""

from __future__ import annotations

import math

import torch

from .traffic import generator


def fan_in(name: str, shape: tuple[int, ...]) -> int:
    """inputs a unit of the parameter sums over: a 2-D conv kernel (out, in,
    kh, kw) over in x kh x kw, any other kernel over all but its last axis"""
    if len(shape) == 4:
        return math.prod(shape[1:])
    return math.prod(shape[:-1])


def draw_state(shapes: dict[str, tuple[int, ...]], seed: int, device,
               damped: dict | None = None) -> dict[str, torch.Tensor]:
    """{parameter name: shape} -> {name: f32 tensor on ``device``}. ``damped``
    ({"scale": s, "names": [substrings]}): a parameter whose name holds one
    of the substrings is drawn s times smaller (the layers the model's own
    initialisation zeroes, so that the samplers' steps stay as short as a
    trained model's and a bf16 rounding is not amplified step by step)"""
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(device, seed, "weights"), device=device)
    state, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            t = t / math.sqrt(fan_in(name, shape))
        elif name.endswith("gamma"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        if damped and any(part in name for part in damped["names"]):
            t = t * damped["scale"]
        state[name] = t
    return state
