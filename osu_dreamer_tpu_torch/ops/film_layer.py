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
``csrc/ffn_core.cuh``) and whose backward is ``csrc/film_layer_bwd.cu`` (K3,
on the backward core of ``csrc/ffn_bwd_core.cuh``, reading the forward's
weight pack) where ``bwd_kernel_fits`` holds, else autograd of
``film_layer_plain`` (bf16 only; anything else raises); any other CUDA input
runs ``film_layer_plain`` on the card, and a CPU tensor ``film_layer_plain``,
both differentiated by autograd.
"""

from __future__ import annotations

import torch

from ..nn.norm import rms_norm
from ._build import check_cuda, run
from .swiglu import (
    _BM_ROWS, bwd_plan, check_ffn_shapes, device_sms, ffn_fwd_inputs, fwd_kernel_fits,
    gemm_splits, packed_ffn_weights, packed_out_bias, swiglu_plain,
)

# the widths K3 takes: every width the JAX package fuses (C 128, 256, 384)
# and the narrow ones below
BWD_WIDTHS = (32, 64, 128, 256, 384)


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
    out, bout = torch.empty_like(x), packed_out_bias(out_bias, vg_kernel, x.dtype)
    run(
        "odt_film_layer_fwd", "film_layer", x.device,
        x.data_ptr(), *(t.data_ptr() for t in film), pack.dww.data_ptr(), pack.dwb.data_ptr(),
        pack.bvg.data_ptr(), bout.data_ptr(), pack.weight_maps(), out.data_ptr(),
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
    bf16 and every other gradient f32. The kernels leave fixed-order f32
    partials of the per-column sums (per CTA or warpgroup), summed here;
    the two weight products run in the same call. The workspace follows the
    backward core's plan (``bwd_plan``) and the B L real rows."""
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
    pack = packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, x.dtype)
    bout = packed_out_bias(out_bias, vg_kernel, x.dtype)
    H, Hp, BL, dev = pack.H, pack.Hp, B * L, x.device
    nwg, sa, sb = bwd_plan(BL, C, Hp, device_sms(dev), film=True)
    nT = -(-L // _BM_ROWS)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    s_vg, s_out = gemm_splits(BL, C, 2 * Hp), gemm_splits(BL, Hp, C)
    dx = torch.empty_like(x)
    work = [torch.empty(sa, BL, C, **f32), torch.empty(sa, BL, **f32),  # pass A: s W_out, sum s^2
            torch.empty(BL, C, **bf), torch.empty(BL, C, **bf),       # y, do
            torch.empty(BL, 2, **f32), torch.empty(B, nT, 3, C, **f32),  # (n, n^3 m), mid sums
            torch.empty(BL, 2 * Hp, **bf), torch.empty(BL, Hp, **bf),  # dvg, hn
            torch.empty(-(-BL // (64 * nwg)) * nwg, 2 * Hp, **f32),   # vg-bias partials
            torch.empty(sb, BL, C, **f32), torch.empty(B, nT, 4 + K, C, **f32),  # dY, finish sums
            torch.empty(s_vg, C, 2 * Hp, **f32), torch.empty(s_out, Hp, C, **f32),
            torch.empty(C, 2 * Hp, **f32), torch.empty(Hp, C, **f32)]  # dW_vg, dW_out
    run(
        "odt_film_layer_bwd", "film_layer_bwd", dev,
        x.data_ptr(), go.data_ptr(), *(t.data_ptr() for t in film), pack.dww.data_ptr(),
        pack.dwb.data_ptr(), pack.bvg.data_ptr(), bout.data_ptr(), pack.weight_maps(),
        dx.data_ptr(), *(t.data_ptr() for t in work),
        B, L, C, H, Hp, K, nwg, sa, sb, s_vg, s_out,
    )
    # per batch row: dgate, dg2, dbout (mid) and dshift, dscale, dg1, d dw_bias,
    # the taps (fin); the FiLM vectors' gradients stay per batch row
    mid, fin, dbvg, dwvg, dwout = work[5].sum(1), work[10].sum(1), work[8].sum(0), work[13], work[14]
    dg2, dbout = mid[:, 1:].sum(0)
    rest = fin[:, 2:].sum(0)
    return (dx, fin[:, 1], fin[:, 0], mid[:, 0], rest[0], dg2, rest[2:], rest[1],
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
