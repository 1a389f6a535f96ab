"""Fused norm + FiLM + packed qkv projection (the denoiser's attention
prologue), forward and backward: the plain PyTorch versions and the CUDA
kernels.

Counterpart of osu_dreamer_tpu/ops/film_qkv.py (``film_qkv_reference``, the
Pallas ``_fwd_kernel`` and ``_bwd_kernel``). Per position:

    y   = rms(x) * (1 + scale) + shift + add
    qkv = y @ W + b

``film_qkv`` dispatches by device: a CUDA tensor goes to ``FilmQKVFunction``,
whose forward is ``film_qkv_fwd`` in ``csrc/film_qkv.cu`` (K11) and whose
backward is ``film_qkv_bwd`` there (K12) (bf16 only; anything else raises); a
CPU tensor to ``film_qkv_plain``, differentiated by autograd. nn/attention.py
takes this path only where the JAX package's own setting asks for it
(``OSU_DREAMER_FUSED_PROLOGUE=1``).
"""

from __future__ import annotations

import torch

from ._build import check_cuda, run
from .swiglu import gemm_splits, shrink_tile_to_budget

# rows per block of the forward kernel (csrc/film_qkv.cu kFqRows); a block
# never crosses a batch row
ROWS = 64
# the widest C the kernels take (csrc/film_qkv.cu kFqMaxV, FqBwdWide)
MAX_C = 1024
# blocks the forward aims for: about two waves on the card's 132 SMs (short
# inputs split the projection's columns across blocks)
_FWD_BLOCKS = 2 * 132


def bwd_rows(C: int) -> int:
    """rows per block of the backward's row kernel (csrc/film_qkv.cu
    FqBwdNarrow / FqBwdWide)"""
    return 64 if C <= 512 else 32


# The JAX prologue's feasibility rule, copied from osu_dreamer_tpu/ops/
# film_qkv.py (``_fwd_vmem_bytes``, ``_bwd_vmem_bytes``) with the shared
# budget search (ops/swiglu.py ``shrink_tile_to_budget``), so that both
# packages take the fused prologue at the same widths.
_DEFAULT_TILE = 512


def _fwd_vmem_bytes(C: int, F: int, tile: int) -> int:
    return 2 * (C * F + F) + tile * (10 * C + 6 * F)


def _bwd_vmem_bytes(C: int, F: int, tile: int) -> int:
    return 2 * (C * F) + 4 * (C * F + F + 2 * C) + tile * (18 * C + 6 * F)


def feasible_fwd_tile(C: int, F: int, tile: int = _DEFAULT_TILE) -> int | None:
    return shrink_tile_to_budget(lambda t: _fwd_vmem_bytes(C, F, t), tile)


def feasible_bwd_tile(C: int, F: int, tile: int = _DEFAULT_TILE) -> int | None:
    return shrink_tile_to_budget(lambda t: _bwd_vmem_bytes(C, F, t), tile)


def film_qkv_plain(
    x: torch.Tensor,       # (B, L, C)
    scale: torch.Tensor,   # (B, C)
    shift: torch.Tensor,   # (B, C)
    add: torch.Tensor,     # (B, L, C)
    kernel: torch.Tensor,  # (C, F)
    bias: torch.Tensor,    # (F,)
) -> torch.Tensor:
    """``film_qkv_reference``: f32 row statistics, then each op in x's dtype
    in its order; the product rounded to x's dtype before the bias is added"""
    dt = x.dtype
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
    y = (xf * inv).to(dt) * (1 + scale[:, None, :].to(dt))
    y = y + shift[:, None, :].to(dt) + add.to(dt)
    return y @ kernel.to(dt) + bias.to(dt)


def film_qkv_bwd_plain(x, scale, shift, add, kernel, bias, grad_out):
    """autograd of ``film_qkv_plain`` -> (dx, dscale, dshift, dadd, dkernel,
    dbias), the order of the JAX ``_vjp_bwd``"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, shift, add, kernel, bias)]
        return torch.autograd.grad(film_qkv_plain(*leaves), leaves, grad_out)


def _check_inputs(x, scale, shift, add, kernel, bias) -> list[torch.Tensor]:
    """raise unless the operands fit bf16 (B, L, C) x as the kernels read them
    -> [scale, shift, add, kernel, bias] in bf16, contiguous"""
    check_cuda("x", x, torch.bfloat16, 3)
    B, L, C = x.shape
    F = kernel.shape[-1]
    if C % 64 or C > MAX_C:
        raise ValueError(f"channels {C} must be a multiple of 64 and at most {MAX_C}")
    if F % 128:
        raise ValueError(f"projection width {F} must be a multiple of 128")
    shapes = {"scale": (scale, (B, C)), "shift": (shift, (B, C)), "add": (add, (B, L, C)),
              "kernel": (kernel, (C, F)), "bias": (bias, (F,))}
    out = []
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        t = t.to(torch.bfloat16).contiguous()
        out.append(t.clone() if t.data_ptr() % 32 else t)  # wmma loads need 32-byte alignment
    return out


def film_qkv_fwd_cuda(x, scale, shift, add, kernel, bias) -> torch.Tensor:
    """K11, csrc/film_qkv.cu: bf16 (B, L, C) -> (B, L, F)"""
    scale, shift, add, kernel, bias = _check_inputs(x, scale, shift, add, kernel, bias)
    B, L, C = x.shape
    F = kernel.shape[1]
    tiles = B * -(-L // ROWS)
    groups = max(1, min(F // 128, -(-_FWD_BLOCKS // tiles)))
    out = torch.empty(B, L, F, dtype=x.dtype, device=x.device)
    run(
        "odt_film_qkv_fwd", "film_qkv_fwd", x.device,
        *(t.data_ptr() for t in (x, scale, shift, add, kernel, bias, out)), B, L, C, F, groups,
    )
    return out


def film_qkv_bwd_cuda(x, scale, shift, add, kernel, bias, grad_out):
    """K12, csrc/film_qkv.cu: the tuple of ``film_qkv_bwd_plain``, dx and
    dadd bf16, every other gradient f32. One row pass writes dx, dadd, y and
    per-block partial sums; dW = y^T g (split-K) and the fixed-order sums of
    the partials run in the same call, so two launches are bit-identical."""
    scale, shift, add, kernel, bias = _check_inputs(x, scale, shift, add, kernel, bias)
    B, L, C = x.shape
    F = kernel.shape[1]
    g = grad_out.to(torch.bfloat16).contiguous()
    if g.shape != (B, L, F) or g.device != x.device:
        raise ValueError(f"grad_out must be {(B, L, F)} on {x.device}, "
                         f"got {tuple(g.shape)} on {g.device}")
    if g.data_ptr() % 32:
        g = g.clone()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    nblk = B * -(-L // bwd_rows(C))
    splits = gemm_splits(B * L, C, F)
    dx, dadd = torch.empty_like(x), torch.empty_like(x)
    y_s = torch.empty(B * L, C, dtype=torch.bfloat16, device=dev)  # the recomputed y
    part_film = torch.empty(nblk, 2 * C, **f32)  # per block: dscale, dshift
    part_db = torch.empty(nblk, F, **f32)
    part_w = torch.empty(splits, C, F, **f32)
    dw, db, film = torch.empty(C, F, **f32), torch.empty(F, **f32), torch.empty(B, 2 * C, **f32)
    run(
        "odt_film_qkv_bwd", "film_qkv_bwd", dev,
        *(t.data_ptr() for t in (x, scale, shift, add, kernel, g, dx, dadd, y_s, part_film,
                                 part_db, part_w, dw, db, film)),
        B, L, C, F, splits,
    )
    return dx, film[:, :C], film[:, C:], dadd, dw, db


class FilmQKVFunction(torch.autograd.Function):
    """K11 forward, K12 backward"""

    @staticmethod
    def forward(ctx, x, scale, shift, add, kernel, bias):
        inputs = (x, scale, shift, add, kernel, bias)
        ctx.save_for_backward(*inputs)
        return film_qkv_fwd_cuda(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        grads = film_qkv_bwd_cuda(*inputs, grad_out)
        return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def film_qkv(x, scale, shift, add, kernel, bias) -> torch.Tensor:
    """the prologue: kernels (forward and backward) for CUDA tensors, the
    plain version (autograd) for CPU tensors"""
    if x.is_cuda:
        return FilmQKVFunction.apply(x, scale, shift, add, kernel, bias)
    if x.device.type != "cpu":
        raise ValueError(f"film_qkv: no implementation for device {x.device}")
    return film_qkv_plain(x, scale, shift, add, kernel, bias)
