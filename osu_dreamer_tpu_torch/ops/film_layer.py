"""FiLM-modulated SwiGLU residual layer, forward and backward: the plain
PyTorch versions and the CUDA kernels.

Counterpart of osu_dreamer_tpu/ops/film_layer.py (``film_layer_reference``,
the Pallas ``_fwd_kernel`` and ``_bwd_kernel``). Per position:

    h   = rms(x) * g1 * (1 + scale) + shift
    h   = SwiGLU(h)
    out = x + rms(h) * g2 * (1 + gate)

``film_layer`` dispatches by device and decides the route before any
launch: a CUDA tensor whose width the forward core takes
(ops/swiglu.py ``fwd_kernel_fits``) goes to ``FilmLayerFunction``, whose
forward is the kernel in ``csrc/film_layer.cu`` (K2, on the core of
``csrc/ffn_core.cuh``) and whose backward is ``csrc/film_layer_bwd.cu`` (K3)
where ``bwd_kernel_fits`` holds, else autograd of ``film_layer_plain`` (bf16
only; anything else raises); any other CUDA input runs ``film_layer_plain``
on the card, and a CPU tensor ``film_layer_plain``, both differentiated by
autograd.
"""

from __future__ import annotations

import torch

from ..nn.norm import rms_norm
from ._build import check_cuda, run
from .swiglu import (
    check_ffn_shapes, ffn_fwd_inputs, fwd_kernel_fits, gemm_splits, packed_bwd_weights,
    swiglu_plain,
)

# the widths K3 takes: every width the JAX package fuses (C 128, 256, 384)
# and the narrow ones below
BWD_WIDTHS = (32, 64, 128, 256, 384)


def bwd_rows(C: int) -> int:
    """extended rows per block of the backward kernel (csrc/film_layer_bwd.cu
    ``fb_rows``: 64, or 32 at C 256 and 16 at C 384 so that its row buffers
    fit shared memory); each block owns bwd_rows - 2r core rows"""
    return 64 if C <= 128 else 32 if C <= 256 else 16


def bwd_kernel_fits(C: int, K: int) -> bool:
    """whether the film-layer backward kernel (K3) takes width C and K taps"""
    return C in BWD_WIDTHS and K % 2 == 1 and K <= 9


def film_layer_plain(
    x: torch.Tensor,       # (B, L, C)
    scale: torch.Tensor,   # (B, C)
    shift: torch.Tensor,   # (B, C)
    gate: torch.Tensor,    # (B, C)
    g1: torch.Tensor,      # (C,) pre-norm gain
    g2: torch.Tensor,      # (C,) block-norm gain
    dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias,
) -> torch.Tensor:
    """every op in x's dtype, in the JAX reference's order"""
    dt = x.dtype
    h = rms_norm(x, g1)
    h = h * (1 + scale[:, None, :].to(dt)) + shift[:, None, :].to(dt)
    h = swiglu_plain(h, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    h = rms_norm(h, g2)
    return x + h * (1 + gate[:, None, :].to(dt))


def _film_inputs(x, scale, shift, gate, g1, g2) -> list[torch.Tensor]:
    """scale, shift, gate (B, C) and g1, g2 (C,) cast to x's dtype, checked"""
    B, _, C = x.shape
    dt = x.dtype
    film = [t.to(dt).contiguous() for t in (scale, shift, gate)]
    for name, t in zip(("scale", "shift", "gate"), film):
        if t.shape != (B, C) or t.device != x.device:
            raise ValueError(f"{name} must be (B, C) = {(B, C)} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    gains = [g.to(dt).contiguous() for g in (g1, g2)]
    for name, g in zip(("g1", "g2"), gains):
        if g.shape != (C,) or g.device != x.device:
            raise ValueError(f"{name} must be ({C},) on {x.device}, "
                             f"got {tuple(g.shape)} on {g.device}")
    return film + gains


def film_layer_cuda(
    x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias,
) -> torch.Tensor:
    """K2, csrc/film_layer.cu: bf16 (B, L, C) -> (B, L, C)"""
    pack, nc, slices, scratch = ffn_fwd_inputs(
        x, (dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias), film=True)
    B, L, C = x.shape
    film = _film_inputs(x, scale, shift, gate, g1, g2)
    out = torch.empty_like(x)
    run(
        "odt_film_layer_fwd", "film_layer", x.device,
        x.data_ptr(), *(t.data_ptr() for t in film), pack.dww.data_ptr(), pack.dwb.data_ptr(),
        pack.bvg.data_ptr(), pack.bout.data_ptr(), pack.weight_maps(), out.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in scratch),
        B, L, C, pack.H, pack.Hp, dw_kernel.shape[0], slices, nc,
    )
    return out


def film_layer_bwd_plain(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                         out_kernel, out_bias, grad_out):
    """autograd of ``film_layer_plain`` -> (dx, dscale, dshift, dgate, dg1,
    dg2, d dw_kernel, d dw_bias, d vg_kernel, d vg_bias, d out_kernel,
    d out_bias), the tuple the JAX ``_fused_film_layer_bwd_impl`` returns"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                   out_kernel, out_bias)]
        return torch.autograd.grad(film_layer_plain(*leaves), leaves, grad_out)


def film_layer_bwd_cuda(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                        out_kernel, out_bias, grad_out):
    """K3, csrc/film_layer_bwd.cu: the tuple of ``film_layer_bwd_plain``, dx
    bf16 and every other gradient f32. The kernel leaves one f32 partial per
    block of the per-column sums, summed here in a fixed order; the two weight
    products run in the same call (split-K, fixed-order reduction)."""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    B, L, C = x.shape
    if not bwd_kernel_fits(C, dw_kernel.shape[0]):
        raise ValueError(f"channels {C} must be one of {BWD_WIDTHS} for the backward kernel")
    go = grad_out.to(torch.bfloat16).contiguous()
    if go.shape != x.shape or go.device != x.device:
        raise ValueError(f"grad_out must be {tuple(x.shape)} on {x.device}, "
                         f"got {tuple(go.shape)} on {go.device}")
    K = dw_kernel.shape[0]
    film = _film_inputs(x, scale, shift, gate, g1, g2)
    weights, H, Hp = packed_bwd_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                                        x.dtype)
    weights = [*weights, out_bias.to(x.dtype).contiguous()]
    nT = -(-L // (bwd_rows(C) - 2 * (K // 2)))
    R = B * nT * bwd_rows(C)
    dev = x.device
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    s_vg, s_out = gemm_splits(R, C, 2 * Hp), gemm_splits(R, Hp, C)
    dx = torch.empty_like(x)
    part = torch.empty(B, nT, (7 + K) * C + 2 * Hp, **f32)
    scratch = [torch.empty(R, C, **bf), torch.empty(R, Hp, **bf), torch.empty(R, C, **bf),
               torch.empty(R, 2 * Hp, **bf)]  # y, hn, do, dvg
    pvg, pout = torch.empty(s_vg, C, 2 * Hp, **f32), torch.empty(s_out, Hp, C, **f32)
    dwvg, dwout = torch.empty(C, 2 * Hp, **f32), torch.empty(Hp, C, **f32)
    run(
        "odt_film_layer_bwd", "film_layer_bwd", dev,
        x.data_ptr(), go.data_ptr(), *(t.data_ptr() for t in film + weights),
        dx.data_ptr(), part.data_ptr(), *(t.data_ptr() for t in scratch),
        *(t.data_ptr() for t in (pvg, pout, dwvg, dwout)),
        B, L, C, H, Hp, K, s_vg, s_out,
    )
    per_row = part[:, :, : 3 * C].sum(1).view(B, 3, C)     # dscale, dshift, dgate
    total = part[:, :, 3 * C :].sum((0, 1))
    dg1, dg2, ddwb, dbout = total[: 4 * C].view(4, C)
    ddw = total[4 * C : (4 + K) * C].view(K, C)
    dbvg = total[(4 + K) * C :]
    return (dx, per_row[:, 0], per_row[:, 1], per_row[:, 2], dg1, dg2, ddw, ddwb,
            torch.cat([dwvg[:, :H], dwvg[:, Hp : Hp + H]], 1),
            torch.cat([dbvg[:H], dbvg[Hp : Hp + H]]), dwout[:H], dbout)


class FilmLayerFunction(torch.autograd.Function):
    """K2 forward; K3 backward where ``bwd_kernel_fits``, else autograd of
    the plain version (the JAX reference's vjp)"""

    @staticmethod
    def forward(ctx, x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                out_kernel, out_bias):
        inputs = (x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                  out_kernel, out_bias)
        ctx.save_for_backward(*inputs)
        return film_layer_cuda(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        C, K = inputs[0].shape[-1], inputs[6].shape[0]
        bwd = film_layer_bwd_cuda if bwd_kernel_fits(C, K) else film_layer_bwd_plain
        grads = bwd(*inputs, grad_out)
        return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def film_layer(
    x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias,
) -> torch.Tensor:
    """film layer: on the card the kernels where ``fwd_kernel_fits`` (the
    backward K3 where ``bwd_kernel_fits``), elsewhere the plain version; the
    plain version (autograd) for CPU tensors"""
    args = (x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
            out_kernel, out_bias)
    if x.is_cuda:
        if fwd_kernel_fits(x.shape[-1], dw_kernel.shape[0], out_kernel.shape[0]):
            return FilmLayerFunction.apply(*args)
        return film_layer_plain(*args)
    if x.device.type != "cpu":
        raise ValueError(f"film_layer: no implementation for device {x.device}")
    return film_layer_plain(*args)
