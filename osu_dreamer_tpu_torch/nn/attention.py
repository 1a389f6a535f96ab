"""RoPE self-attention.

Counterpart of osu_dreamer_tpu/nn/attention.py (``rope``, ``RoPEAttention``):
packed qkv projection (optionally after a pre-norm FiLM and an added
stream), per-head RMS norm of q and k with learned gains, rotary position
embedding, softmax attention, output projection. ``attention_route``
(ops/fused_attention.py) decides, the same on every device: where the JAX
``fused_attention_fits`` holds the attention goes straight off the packed
projection through ``fused_norm_rope_attention`` (forward and backward
kernels on the card, at every head dim and length the gate admits);
elsewhere q and k are normalised and rotated by ``norm_rope_qkv``
(ops/norm_rope.py: one pass each way on the card) and go to
``long_flash_attention`` (ops/long_attention.py: forward and backward
kernels at any shape), as the JAX package does.
With a sequence-parallel group (``sp``) the route is not asked: q and k are
normalised and rotated here at the shard's global offset and go through
``ring_attention`` (ops/ring_attention.py), as in the JAX package. On
the FiLM path the norm, FiLM, add and qkv projection run as one fused
prologue (ops/film_qkv.py) where ``prologue_ok`` holds: the JAX package's
opt-in setting ``OSU_DREAMER_FUSED_PROLOGUE=1`` and its feasibility rule.

Under tensor parallelism (parallel/tp.py) the module holds its rank's heads
(``tp``): their q, k and v columns of the packed projection and their rows
of ``out``. The projection's input enters the model group (``enter_model``),
the attention runs on the rank's heads (the same routes), and the out
projection's f32 partial leaves through ``leave_model``, its bias added once
after the sum. Where ``prologue_tp_ok`` holds, the prologue runs its TP forms
(ops/film_qkv.py ``film_qkv_tp``: K11 on the rank's columns, K12 split at
its dy), whose backward sums the input gradient itself, so the input does
not enter the model group. (The JAX gate is off under GSPMD, which cannot
partition a TPU custom call; one rank a device has no such limit.)
"""

from __future__ import annotations

import os

import torch
from torch import nn

from ..ops.film_qkv import feasible_bwd_tile, feasible_fwd_tile, film_qkv, film_qkv_tp
from ..ops.fused_attention import attention_route, fused_norm_rope_attention, rope
from ..ops.long_attention import long_flash_attention
from ..ops.norm_rope import norm_rope_qkv
from ..ops.ring_attention import ring_attention
from ..parallel.collectives import enter_model, group_rank, leave_model
from .blocks import Dense
from .norm import rms_norm


def prologue_ok(C: int, F: int) -> bool:
    """the JAX ``_prologue_ok`` (osu_dreamer_tpu/nn/attention.py), read on
    every call: ``OSU_DREAMER_FUSED_PROLOGUE=1``, lane-aligned widths and its
    forward and backward footprints (the copied rule). Its TPU backend test
    has no counterpart here"""
    return os.environ.get("OSU_DREAMER_FUSED_PROLOGUE", "0") == "1" \
        and C % 128 == 0 and F % 128 == 0 and feasible_fwd_tile(C, F) is not None \
        and feasible_bwd_tile(C, F) is not None


def prologue_tp_ok(C: int, heads: int, head_dim: int, tp: int) -> bool:
    """the prologue's TP forms on a model group of ``tp`` ranks holding
    ``heads`` heads split as parallel/tp.py ``even_split`` splits them:
    ``prologue_ok`` on every rank's qkv width 3 x heads_r x head_dim (the
    widths of the largest and the smallest share), so that every rank of
    the group takes the same route and the backward's sums pair up"""
    shares = {heads // tp, -(-heads // tp)}
    return all(prologue_ok(C, 3 * n * head_dim) for n in shares)


class _MmF32(torch.autograd.Function):
    """bf16 a (M, K) @ b (K, N) on the card, accumulated and returned in f32
    (``torch.mm``'s ``out_dtype``, which has no derivative); the backward
    in the operands' dtype, as autograd of their bf16 product gives it"""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        return grad @ b.t(), a.t() @ grad


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (a (..., K), b (K, N)) accumulated and returned in f32"""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return _MmF32.apply(a.reshape(-1, a.shape[-1]), b).view(*a.shape[:-1], b.shape[-1])
    return (a @ b).float()


class RoPEAttention(nn.Module):
    """multi-head self-attention over (B, L, C) with RoPE and q/k norms;
    ``tp``: this rank's share of the heads (None: all of them)"""

    def __init__(self, in_dim: int, n_heads: int, head_dim: int, out_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.n_heads, self.head_dim, self.dtype = n_heads, head_dim, dtype
        self.qkv = Dense(in_dim, 3 * n_heads * head_dim, dtype)
        self.q_gamma = nn.Parameter(torch.ones(head_dim))
        self.k_gamma = nn.Parameter(torch.ones(head_dim))
        self.out = Dense(n_heads * head_dim, out_dim, dtype)
        self.tp = None

    def tp_units(self) -> tuple[int, int]:
        """(heads, entries a head) for parallel/tp.py"""
        return self.n_heads, self.head_dim

    def _project_out(self, y: torch.Tensor) -> torch.Tensor:
        """the out projection; on a tensor-parallel rank the sum of the
        ranks' f32 partials, the bias added once"""
        if self.tp is None:
            return self.out(y)
        dt = self.dtype
        part = leave_model(_mm_f32(y.to(dt), self.out.kernel.to(dt)), self.tp.group)
        return part.to(dt) + self.out.bias.to(dt)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init of the gains (ones); the Dense children reset themselves"""
        with torch.no_grad():
            self.q_gamma.fill_(1.0)
            self.k_gamma.fill_(1.0)

    def forward(
        self,
        x: torch.Tensor,
        film: tuple[torch.Tensor, torch.Tensor] | None = None,
        add: torch.Tensor | None = None,
        sp=None,
    ) -> torch.Tensor:
        """``film=(scale, shift)`` (each (B, C)) applies the caller's pre-norm
        FiLM before the qkv projection; ``add`` is a position-local stream
        added after it; ``sp``: the sequence-parallel group ``x``'s length is
        sharded over (this rank's span of the window)"""
        dt = self.dtype
        B, L, C = x.shape
        H, D = self.n_heads, self.head_dim
        if self.tp is not None:
            H = self.tp.hi - self.tp.lo
        if film is not None and (prologue_ok(C, 3 * H * D) if self.tp is None else
                                 prologue_tp_ok(C, self.tp.units, D, self.tp.size)):
            a = x.new_zeros(B, L, C, dtype=dt) if add is None else add.to(dt)
            args = (x.to(dt), *film, a, self.qkv.kernel, self.qkv.bias)
            qkv = film_qkv(*args) if self.tp is None else film_qkv_tp(*args, self.tp.group)
        else:
            if film is None:
                h = x.to(dt)
            else:
                scale, shift = film
                h = rms_norm(x) * (1 + scale[:, None, :].to(dt)) + shift[:, None, :].to(dt)
            if add is not None:
                h = h + add.to(dt)
            if self.tp is not None:
                h = enter_model(h, self.tp.group)
            qkv = self.qkv(h)
        if sp is not None:
            q, k, v = (t.reshape(B, L, H, D) for t in qkv.split(H * D, dim=-1))
            offset = group_rank(sp) * L
            q = rope(rms_norm(q, self.q_gamma), offset)
            k = rope(rms_norm(k, self.k_gamma), offset)
            return self.out(ring_attention(q, k, v, sp).reshape(B, L, H * D))
        if attention_route(L, H, D) == "fused":
            return self._project_out(fused_norm_rope_attention(qkv, self.q_gamma, self.k_gamma, H))
        q, k, v = norm_rope_qkv(qkv, self.q_gamma, self.k_gamma, H)
        return self._project_out(long_flash_attention(q, k, v))
