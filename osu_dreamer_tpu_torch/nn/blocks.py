"""Linear layers, the depthwise conv, SwiGLU and the FiLM-gated stack.

Counterparts of flax ``nn.Dense`` and osu_dreamer_tpu/nn/blocks.py
(``DepthwiseConv``, ``SwiGLU``, ``FilmStack``). Parameter names and layouts
follow the flax modules (Dense kernels are (in, out)), so a flax parameter
tree maps onto ``state_dict()`` key for key
(models/inference/artifact.py). Parameters are f32; every module computes in
its ``dtype`` and casts each parameter at use (a differentiable cast, so
gradients reach the f32 parameters). ``reset_parameters(generator)``
initialises a module as its flax counterpart does: ``lecun_normal`` kernels,
zero biases, the layers flax zero-initialises at zero.

Under tensor parallelism (parallel/tp.py ``shard_model``) a ``SwiGLU`` holds
its rank's slice of the hidden units (``tp``) and runs the TP forms of the
FFN kernels, and a ``FilmStack``'s FFNs the film layer's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.film_layer import film_layer, film_layer_tp
from ..ops.ring_attention import halo_exchange
from ..ops.swiglu import swiglu, swiglu_tp
from ..parallel.tp import TPLayout, shard_model
from .norm import RMSNorm

# the standard deviation of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in"""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``, the product
    rounded to ``dtype`` before the bias is added. ``zero_init`` is flax's
    ``kernel_init=zeros``; ``bias_init`` the bias's constant"""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 zero_init: bool = False, bias_init: float = 0.0):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype, self.zero_init, self.bias_init = dtype, zero_init, bias_init

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.kernel.zero_()
            else:
                lecun_normal_(self.kernel, self.kernel.shape[0], generator)
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class MLP(nn.Module):
    """flax ``nn.Sequential([Dense, silu, Dense])``: children named
    ``layers_0`` and ``layers_2`` as flax names them"""

    def __init__(self, in_features: int, hidden: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.layers_0 = Dense(in_features, hidden, dtype)
        self.layers_2 = Dense(hidden, out_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(F.silu(self.layers_0(x)))


class DepthwiseConv(nn.Module):
    """width-K SAME depthwise conv over (B, L, C) as a K-tap shifted sum;
    kernel (K, 1, C) and bias (C,) as in the JAX package"""

    def __init__(self, features: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(width, 1, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's fans of a (K, 1, C) kernel: fan_in = 1 * K"""
        with torch.no_grad():
            lecun_normal_(self.kernel, self.kernel.shape[0], generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        K, L = self.kernel.shape[0], x.shape[1]
        lo = (K - 1) // 2
        xp = F.pad(x.to(dt), (0, 0, lo, K - 1 - lo))
        k = self.kernel.to(dt)
        return sum(xp[:, i : i + L] * k[i, 0] for i in range(K)) + self.bias.to(dt)


class SwiGLU(nn.Module):
    """depthwise-conv gated FFN (ops/swiglu.py) with hidden width
    int(dim * expand * 2 / 3); ``tp``: this rank's share of the hidden units
    (None: all of them). At ``radius`` 0 the JAX module declares no conv
    and runs none: here the FFN runs with a unit tap (a (1, dim) kernel of
    ones and a zero bias, held as buffers outside the state dict and never
    trained), ``x * 1 + 0 = x`` exactly, so the kernels compute the
    conv-free function"""

    def __init__(self, dim: int, expand: int, radius: int, dtype: torch.dtype):
        super().__init__()
        h = int(dim * expand * 2 / 3)
        if radius > 0:
            self.dw_kernel = nn.Parameter(torch.zeros(1 + 2 * radius, dim))
            self.dw_bias = nn.Parameter(torch.zeros(dim))
        else:
            self.register_buffer("dw_kernel", torch.ones(1, dim), persistent=False)
            self.register_buffer("dw_bias", torch.zeros(dim), persistent=False)
        self.vg_kernel = nn.Parameter(torch.zeros(dim, 2 * h))
        self.vg_bias = nn.Parameter(torch.zeros(2 * h))
        self.out_kernel = nn.Parameter(torch.zeros(h, dim))
        self.out_bias = nn.Parameter(torch.zeros(dim))
        self.radius, self.dtype = radius, dtype
        self.tp = None

    def tp_units(self) -> tuple[int, int]:
        """(hidden units, entries a unit) for parallel/tp.py"""
        return self.out_kernel.shape[0] if self.tp is None else self.tp.units, 1

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal kernels (a (K, C) conv kernel has fan_in K), zero
        biases; nothing drawn for the unit tap of radius 0"""
        kernels, biases = [self.vg_kernel, self.out_kernel], [self.vg_bias, self.out_bias]
        if self.radius > 0:
            kernels.insert(0, self.dw_kernel)
            biases.insert(0, self.dw_bias)
        with torch.no_grad():
            for kernel in kernels:
                lecun_normal_(kernel, kernel.shape[0], generator)
            for bias in biases:
                bias.zero_()

    def weights(self) -> tuple[torch.Tensor, ...]:
        return (self.dw_kernel, self.dw_bias, self.vg_kernel, self.vg_bias,
                self.out_kernel, self.out_bias)

    def forward(self, x: torch.Tensor, sp=None) -> torch.Tensor:
        """``sp``: the sequence-parallel group ``x``'s length is sharded
        over. The kernel then runs on the shard with ``radius`` halo frames
        from each neighbour (``halo_exchange``; none at radius 0) and the
        shard's rows are kept: every stage after the depthwise conv is per
        frame, so they are the unsharded rows"""
        x = x.to(self.dtype)
        if self.tp is not None:
            return swiglu_tp(x, *self.weights(), self.tp.units, self.tp.group)
        r = self.radius
        if sp is None or r == 0:
            return swiglu(x, *self.weights())
        return swiglu(halo_exchange(x, r, sp), *self.weights())[:, r:r + x.shape[1]]


class FilmStack(nn.Module):
    """n pre-norm residual SwiGLU layers, each FiLM-modulated by a per-row
    conditioning vector when ``cond_dim`` > 0 (ops/film_layer.py):

        x <- x + blocknorm(SwiGLU(norm(x) * (1 + scale) + shift)) * (1 + gate)

    then an output norm. Unconditioned stacks pass zero scale/shift/gate."""

    def __init__(self, dim: int, cond_dim: int, n_layers: int, expand: int, radius: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dim, self.n_layers, self.dtype = dim, n_layers, dtype
        for i in range(n_layers):
            if cond_dim > 0:
                self.add_module(f"film{i}", Dense(cond_dim, 3 * dim, dtype, zero_init=True))
            self.add_module(f"norm{i}", RMSNorm(dim))
            self.add_module(f"ffn{i}", SwiGLU(dim, expand, radius, dtype))
            self.add_module(f"blocknorm{i}", RMSNorm(dim, gain=1e-3))
        self.out_norm = RMSNorm(dim)
        self.cond_dim = cond_dim

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        if (cond is not None) != (self.cond_dim > 0):
            raise ValueError("cond must be given exactly when cond_dim > 0")
        x = x.to(self.dtype)
        zero = x.new_zeros(x.shape[0], self.dim)
        for i in range(self.n_layers):
            if cond is None:
                scale = shift = gate = zero
            else:
                scale, shift, gate = getattr(self, f"film{i}")(cond).chunk(3, dim=-1)
            ffn = getattr(self, f"ffn{i}")
            args = (x, scale, shift, gate, getattr(self, f"norm{i}").gamma,
                    getattr(self, f"blocknorm{i}").gamma, *ffn.weights())
            x = film_layer(*args) if ffn.tp is None else film_layer_tp(
                *args, ffn.tp.units, ffn.tp.group)
        return self.out_norm(x)


def shard_tensor_parallel(model: nn.Module, par) -> TPLayout | None:
    """this rank's slices of ``model`` (the whole model, initialised) under
    ``par``'s tensor parallelism -> its layout (None: no tensor parallelism,
    or nothing to split). Every slice runs the TP forms, routed as the
    one-rank ops (ops/swiglu.py ``swiglu_tp_route``, ops/film_layer.py
    ``film_layer_tp_route``)"""
    if par is None or par.tp <= 1:
        return None
    return shard_model(model, par.model_group, par.model_rank, par.tp)
