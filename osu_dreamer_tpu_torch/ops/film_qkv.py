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

Tensor parallelism (``film_qkv_tp``, parallel/tp.py): a rank holds its
heads' q, k and v columns of the projection; x, scale, shift and add are
replicated. ``FilmQKVTPFunction`` runs the TP forms: the forward is K11 on
the rank's columns (nothing to sum); the backward splits K12 where dy =
g W^T is formed: phase 0 (the y pass, the row pass's products left as this
rank's f32 dy partial, the slice's dW and db), the dy sum over the model
group, phase 1 (dx, dadd and the FiLM gradients from the summed dy, equal
on every rank, so they are not summed again). On the CPU the plain versions
split at the same seam.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import tp_all_reduce_
from ._build import check_cuda, run
from .swiglu import _MAX_SMEM, gemm_splits, grads_of, shrink_tile_to_budget

# the widest C the kernels take (csrc/film_qkv.cu: the forward's y tile,
# the backward's four-CTA clusters)
MAX_C = 1024
# csrc/film_qkv.cu's forward plan: 128 output columns a work item, a ring of
# 16 KB stages, 8 KB (64 x 64 bf16) tiles, at most 8 stages
FWD_COLS = 128
_TILE_BYTES = 64 * 64 * 2
_STAGE_BYTES = 2 * _TILE_BYTES
_MAX_STAGES = 8
# and its backward's (``FqbLayout``, ``fqb_*``): 128-row tiles, at most four
# 64-column boxes of dy a CTA and four CTAs a tile, 8 consumer warps of 16
# rows each
BWD_ROWS = 128
_BWD_MAX_BOXES = 4
_BWD_MAX_CLUSTER = 4
_BWD_WARPS = 8
# and its TP form's phase 1 (``kFqtRows``): rows of one batch row a CTA
TP_ROWS = 32


def fwd_plan(B: int, L: int, C: int, F: int, sms: int = 132) -> dict[str, int]:
    """the forward kernel's plan (csrc/film_qkv.cu ``fqf_warpgroups``,
    ``FqfLayout``, ``fqf_stages``): consumer warpgroups of 64 rows, ring
    stages, shared-memory bytes, row tiles, (row tile, column group) work
    items and persistent CTAs"""
    nwg = 2 if C <= 512 else 1
    # y tiles, epilogue tiles, 1/rms rows, barriers, the base's alignment slack
    fixed = ((C // 64) * nwg * _TILE_BYTES + nwg * 2 * _TILE_BYTES + 64 * nwg * 4
             + (2 * _MAX_STAGES + 2) * 8 + 1024)
    stages = min(_MAX_STAGES, (_MAX_SMEM - fixed) // _STAGE_BYTES) if fixed <= _MAX_SMEM else 0
    tiles = -(-(B * L) // (64 * nwg))
    items = tiles * (F // FWD_COLS)
    return {"warpgroups": nwg, "rows": 64 * nwg, "stages": stages,
            "smem": fixed + stages * _STAGE_BYTES, "tiles": tiles, "items": items,
            "ctas": min(items, sms)}


def fwd_items(tiles: int, ngrp: int, ctas: int) -> list[list[int]]:
    """each forward CTA's work items in order, item = tile ngrp + column
    group (csrc/film_qkv.cu): tiles // ctas whole tiles, then a share of one
    of the tiles left over, whose column groups that tile's CTAs split"""
    whole, left = divmod(tiles, ctas)
    out = []
    for b in range(ctas):
        items = list(range(b * whole * ngrp, (b + 1) * whole * ngrp))
        if left:
            t = b * left // ctas
            b0 = -(-t * ctas // left)
            n = -(-(t + 1) * ctas // left) - b0
            first = (ctas * whole + t) * ngrp
            items += range(first + (b - b0) * ngrp // n, first + (b - b0 + 1) * ngrp // n)
        out.append(items)
    return out


def bwd_plan(B: int, L: int, C: int, F: int, held: int | None = None) -> dict[str, int]:
    """the backward row pass's plan (csrc/film_qkv.cu ``fqb_cluster``,
    ``fqb_boxes``, ``fqb_segments``, ``FqbLayout``, ``fqb_stages``): the CTAs
    of a tile's cluster, the 64-column boxes of dy a CTA, ring stages,
    shared-memory bytes, 128-row tiles, the batch rows a consumer warp's 16
    rows can meet (its film partials) and the persistent clusters (``held``:
    as many as the device holds at once, by default one CTA an SM of 132)"""
    n = -(-(C // 64) // _BWD_MAX_BOXES)
    nb = -(-(C // 64) // n)
    stage = (2 + nb) * _TILE_BYTES
    # the output staging tile, the exchanged row sums, barriers, alignment slack
    fixed = (2 * _TILE_BYTES + 2 * _BWD_MAX_CLUSTER * BWD_ROWS * 4 + (2 * _MAX_STAGES + 2) * 8
             + 1024)
    stages = min(_MAX_STAGES, (_MAX_SMEM - fixed) // stage)
    tiles = -(-(B * L) // BWD_ROWS)
    clusters = min(tiles, 132 // n if held is None else held)
    return {"cluster": n, "boxes": nb, "stages": stages, "smem": fixed + stages * stage,
            "tiles": tiles, "segments": (14 + L) // L + 1, "clusters": clusters,
            "ctas": clusters * n}


def bwd_tiles(tiles: int, clusters: int) -> list[list[int]]:
    """each backward cluster's row tiles in order (csrc/film_qkv.cu: cluster
    c takes c, c + clusters, ...)"""
    return [list(range(c, tiles, clusters)) for c in range(clusters)]


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
    return film_y_plain(x, scale, shift, add) @ kernel.to(dt) + bias.to(dt)


def film_y_plain(x, scale, shift, add) -> torch.Tensor:
    """the y the projection multiplies: rms(x) (1 + scale) + shift + add"""
    dt = x.dtype
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
    y = (xf * inv).to(dt) * (1 + scale[:, None, :].to(dt))
    return y + shift[:, None, :].to(dt) + add.to(dt)


def film_qkv_bwd_plain(x, scale, shift, add, kernel, bias, grad_out):
    """autograd of ``film_qkv_plain`` -> (dx, dscale, dshift, dadd, dkernel,
    dbias), the order of the JAX ``_vjp_bwd``"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, scale, shift, add, kernel, bias)]
        return torch.autograd.grad(film_qkv_plain(*leaves), leaves, grad_out)


def _check_inputs(x, scale, shift, add, kernel, bias) -> list[torch.Tensor]:
    """raise unless the operands fit bf16 (B, L, C) x as the kernels read them
    -> [scale, shift, add, kernel, bias] in bf16, contiguous, each base
    16-byte aligned (a copy where it is not), as the TMA boxes and 16-byte
    loads of both kernels read them"""
    check_cuda("x", x, torch.bfloat16, 3)
    B, L, C = x.shape
    F = kernel.shape[-1]
    if C % 64 or C > MAX_C:
        raise ValueError(f"channels {C} must be a multiple of 64 and at most {MAX_C}")
    if F % FWD_COLS:
        raise ValueError(f"projection width {F} must be a multiple of {FWD_COLS}")
    shapes = {"scale": (scale, (B, C)), "shift": (shift, (B, C)), "add": (add, (B, L, C)),
              "kernel": (kernel, (C, F)), "bias": (bias, (F,))}
    out = []
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        t = t.to(torch.bfloat16).contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _check_y_out(y_out: torch.Tensor, B: int, L: int, C: int) -> None:
    check_cuda("y_out", y_out, torch.bfloat16, 2)
    if tuple(y_out.shape) != (B * L, C):
        raise ValueError(f"y_out must be {(B * L, C)}, got {tuple(y_out.shape)}")


def film_qkv_fwd_cuda(x, scale, shift, add, kernel, bias,
                      y_out: torch.Tensor | None = None, counter: str = "film_qkv_fwd"
                      ) -> torch.Tensor:
    """K11, csrc/film_qkv.cu: bf16 (B, L, C) -> (B, L, F). ``y_out`` (B L, C)
    bf16, a test hook: the kernel writes there the y it multiplies;
    ``counter``: the launch count it adds to"""
    scale, shift, add, kernel, bias = _check_inputs(x, scale, shift, add, kernel, bias)
    B, L, C = x.shape
    F = kernel.shape[1]
    if y_out is not None:
        _check_y_out(y_out, B, L, C)
    out = torch.empty(B, L, F, dtype=x.dtype, device=x.device)
    run(
        "odt_film_qkv_fwd", counter, x.device,
        *(t.data_ptr() for t in (x, scale, shift, add, kernel, bias, out)),
        0 if y_out is None else y_out.data_ptr(), B, L, C, F,
    )
    return out


def film_qkv_bwd_cuda(x, scale, shift, add, kernel, bias, grad_out,
                      y_out: torch.Tensor | None = None):
    """K12, csrc/film_qkv.cu: the tuple of ``film_qkv_bwd_plain``, dx and
    dadd bf16, every other gradient f32. A y pass recomputes y and 1/rms; the
    row pass (dy = g W^T on wgmma) writes dx, dadd and partial sums; dW =
    y^T g (split-K) and the fixed-order sums of the partials run in the same
    call, so two launches are bit-identical. ``y_out`` (B L, C) bf16, a test
    hook: the y pass recomputes y there."""
    scale, shift, add, kernel, bias = _check_inputs(x, scale, shift, add, kernel, bias)
    B, L, C = x.shape
    F = kernel.shape[1]
    g = grad_out.to(torch.bfloat16).contiguous()
    if g.shape != (B, L, F) or g.device != x.device:
        raise ValueError(f"grad_out must be {(B, L, F)} on {x.device}, "
                         f"got {tuple(g.shape)} on {g.device}")
    if g.data_ptr() % 16:
        g = g.clone()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    plan = bwd_plan(B, L, C, F)
    splits = gemm_splits(B * L, C, F)
    dx, dadd = torch.empty_like(x), torch.empty_like(x)
    y_s = y_out  # the recomputed y
    if y_s is None:
        y_s = torch.empty(B * L, C, dtype=torch.bfloat16, device=dev)
    else:
        _check_y_out(y_s, B, L, C)
    rinv = torch.empty(B * L, **f32)
    # per (consumer warp, batch row of its 16 rows): dscale, dshift; per
    # half tile: db
    part_film = torch.empty(_BWD_WARPS * plan["tiles"], plan["segments"], 2 * C, **f32)
    part_db = torch.empty(2 * plan["tiles"], F, **f32)
    part_w = torch.empty(splits, C, F, **f32)
    dw, db, film = torch.empty(C, F, **f32), torch.empty(F, **f32), torch.empty(B, 2 * C, **f32)
    run(
        "odt_film_qkv_bwd", "film_qkv_bwd", dev,
        *(t.data_ptr() for t in (x, scale, shift, add, kernel, g, dx, dadd, y_s, rinv, part_film,
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


# ------------------------------------------------------ tensor parallelism ----


def film_qkv_tp_fwd_cuda(x, scale, shift, add, kernel, bias) -> torch.Tensor:
    """K11's TP form: K11 on the rank's columns (``kernel`` (C, F_r),
    ``bias`` (F_r,)); its inputs are replicated and its output columns the
    rank's own, so nothing is summed. Counted as ``film_qkv_tp``"""
    return film_qkv_fwd_cuda(x, scale, shift, add, kernel, bias, counter="film_qkv_tp")


def film_qkv_tp_bwd_cuda(x, scale, shift, add, kernel, bias, grad_out):
    """K12's TP form, csrc/film_qkv.cu ``odt_film_qkv_bwd_tp``, on the rank's
    columns: phase 0 now (the y pass; the row pass's products left as this
    rank's dy partial; the slice's dW on csrc/gemm_tn.cuh and db, fixed-order
    sums) -> (the dy partial (B L, C) f32 to sum over the model group,
    (dkernel, dbias) of the slice f32, finish); ``finish()`` runs phase 1 on
    the summed dy -> (dx, dscale, dshift, dadd), dx and dadd bf16"""
    scale, shift, add, kernel, bias = _check_inputs(x, scale, shift, add, kernel, bias)
    B, L, C = x.shape
    F = kernel.shape[1]
    g = grad_out.to(torch.bfloat16).contiguous()
    if g.shape != (B, L, F) or g.device != x.device:
        raise ValueError(f"grad_out must be {(B, L, F)} on {x.device}, "
                         f"got {tuple(g.shape)} on {g.device}")
    if g.data_ptr() % 16:
        g = g.clone()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    splits = gemm_splits(B * L, C, F)
    dx, dadd = torch.empty_like(x), torch.empty_like(x)
    y_s, rinv = torch.empty(B * L, C, dtype=torch.bfloat16, device=dev), torch.empty(B * L, **f32)
    dy = torch.empty(B * L, C, **f32)
    part_film = torch.empty(B, -(-L // TP_ROWS), 2 * C, **f32)
    part_db = torch.empty(2 * -(-(B * L) // BWD_ROWS), F, **f32)
    part_w = torch.empty(splits, C, F, **f32)
    dw, db, film = torch.empty(C, F, **f32), torch.empty(F, **f32), torch.empty(B, 2 * C, **f32)
    args = [*(t.data_ptr() for t in (x, scale, shift, add, kernel, g, dx, dadd, y_s, rinv, dy,
                                      part_film, part_db, part_w, dw, db, film)),
            B, L, C, F, splits]
    run("odt_film_qkv_bwd_tp", "film_qkv_bwd_tp", dev, *args, 0)

    def finish(held=(x, scale, rinv, dy, part_film)):
        """phase 1 (``held``: the tensors it reads, alive until it has)"""
        run("odt_film_qkv_bwd_tp", "film_qkv_bwd_tp", dev, *args, 1, count=False)
        return dx, film[:, :C], film[:, C:], dadd

    return dy, (dw, db), finish


def film_qkv_tp_bwd_plain(x, scale, shift, add, kernel, bias, grad_out):
    """the plain version of ``film_qkv_tp_bwd_cuda``, split at the same
    seam: dy = g W^T of the rank's columns accumulated in f32, the slice's
    dW = y^T g and db; ``finish()``: autograd of y on the summed dy"""
    dt = x.dtype
    B, L, C = x.shape
    F = kernel.shape[1]
    g = grad_out.to(dt).reshape(B * L, F).float()
    y = film_y_plain(x, scale, shift, add).reshape(B * L, C).float()
    dy = g @ kernel.to(dt).float().t()

    def finish():
        return grads_of(film_y_plain, (x, scale, shift, add), dy.view(B, L, C).to(dt))

    return dy, (y.t() @ g, g.sum(0)), finish


def film_qkv_tp_bwd(x, scale, shift, add, kernel, bias, grad_out):
    """K12's TP form for a CUDA tensor, its plain version for a CPU tensor"""
    fn = film_qkv_tp_bwd_cuda if x.is_cuda else film_qkv_tp_bwd_plain
    return fn(x, scale, shift, add, kernel, bias, grad_out)


class FilmQKVTPFunction(torch.autograd.Function):
    """the TP forms on one rank's columns: K11's forward (the plain version
    on the CPU); K12's phase 0, the model group's sum of the dy partials,
    phase 1"""

    @staticmethod
    def forward(ctx, x, scale, shift, add, kernel, bias, group):
        inputs = (x, scale, shift, add, kernel, bias)
        ctx.save_for_backward(*inputs)
        ctx.group = group
        return film_qkv_tp_fwd_cuda(*inputs) if x.is_cuda else film_qkv_plain(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        dy, (dw, db), finish = film_qkv_tp_bwd(*inputs, grad_out)
        tp_all_reduce_(dy, ctx.group)
        grads = (*finish(), dw, db)
        return (*(g.to(t.dtype) for g, t in zip(grads, inputs)), None)


def film_qkv_tp(x, scale, shift, add, kernel, bias, group) -> torch.Tensor:
    """the prologue on a tensor-parallel rank holding its heads' columns of
    the projection (``kernel`` (C, F_r), ``bias`` (F_r,)); the model group
    ``group`` sums the backward's dy partials"""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"film_qkv_tp: no implementation for device {x.device}")
    return FilmQKVTPFunction.apply(x, scale, shift, add, kernel, bias, group)
