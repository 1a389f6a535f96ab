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

Tensor parallelism (``film_layer_tp``, parallel/tp.py): a rank holds a slice
of the FFN's hidden units. ``FilmLayerTPFunction`` runs the TP forms: the
forward (the pre-norm, FiLM and conv on the whole x and the slice's f32
partials, their sum over the model group, then the finish: 1 / rms over the
whole hidden width, b_out once, the block norm and the gated residual) and
the backward (the block norm's backward and n, m from the forward's summed
partials, pass B on the slice, the dY sum over the model group, then the
FiLM finish). A slice is routed as the one-rank op (``film_layer_tp_route``):
on the card the K2 TP form where the forward core takes the largest slice,
then the K3 TP form where ``bwd_kernel_fits`` holds; elsewhere, and on the
CPU, the plain versions of the forms.
"""

from __future__ import annotations

import torch

from ..nn.norm import rms_norm
from ..parallel.collectives import group_size, tp_all_reduce_
from ._build import check_cuda, run
from .swiglu import (
    _BM_ROWS, bwd_plan, check_ffn_shapes, depthwise_conv, device_sms, ffn_fwd_inputs,
    fwd_kernel_fits, gemm_splits, grads_of, packed_ffn_weights, packed_out_bias, split_partials,
    swiglu_plain, tp_bwd_plan, tp_dy, tp_fwd_plan, tp_hidden_pads, tp_out_plain,
    tp_partial_plain, tp_slice_grads, tp_workspace, tp_workspace_grads,
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
    h = swiglu_plain(film_in(x, scale, shift, g1), dw_kernel, dw_bias, vg_kernel, vg_bias,
                     out_kernel, out_bias)
    return film_out(x, h, gate, g2)


def film_in(x, scale, shift, g1) -> torch.Tensor:
    """the pre-norm and FiLM: rms(x) g1 (1 + scale) + shift"""
    dt = x.dtype
    return rms_norm(x, g1) * (1 + scale[:, None, :].to(dt)) + shift[:, None, :].to(dt)


def film_out(x, h, gate, g2) -> torch.Tensor:
    """the block norm and the gated residual: x + rms(h) g2 (1 + gate)"""
    return x + rms_norm(h, g2) * (1 + gate[:, None, :].to(x.dtype))


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
    dgate, dg2, dbout = _mid_grads(work[5])
    dscale, dshift, dg1, ddw, ddwb = _fin_grads(work[10])
    return (dx, dscale, dshift, dgate, dg1, dg2, ddw, ddwb,
            *_ffn_grads(work[8], work[13], work[14], H, Hp), dbout)


def _mid_grads(mid) -> tuple[torch.Tensor, ...]:
    """the row statistics' per-CTA partials (B, tiles, 3, C) -> (dgate per
    batch row, dg2, d out_bias)"""
    mid = mid.sum(1)
    dg2, dbout = mid[:, 1:].sum(0)
    return mid[:, 0], dg2, dbout


def _fin_grads(fin) -> tuple[torch.Tensor, ...]:
    """the finish's per-CTA partials (B, tiles, 4 + K, C) -> (dscale and
    dshift per batch row, dg1, d dw_kernel, d dw_bias)"""
    fin = fin.sum(1)
    rest = fin[:, 2:].sum(0)
    return fin[:, 1], fin[:, 0], rest[0], rest[2:], rest[1]


def _ffn_grads(dbvg, dwvg, dwout, H: int, Hp: int) -> tuple[torch.Tensor, ...]:
    """the padded layout -> (d vg_kernel, d vg_bias, d out_kernel) of H units"""
    db = dbvg.sum(0)
    return (torch.cat([dwvg[:, :H], dwvg[:, Hp : Hp + H]], 1), torch.cat([db[:H], db[Hp : Hp + H]]),
            dwout[:H])


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


# ------------------------------------------------------ tensor parallelism ----


def film_layer_tp_route(C: int, K: int, H: int, tp: int, device: torch.device
                       ) -> tuple[str, str]:
    """(forward, backward) of a TP slice of H hidden units over tp ranks on
    ``device``, as one-rank ``film_layer`` routes: on the card "kernel" (the
    K2 TP form) where ``fwd_kernel_fits`` holds at the largest slice's padded
    width, then "kernel" (the K3 TP form) where ``bwd_kernel_fits`` holds,
    else "plain"; elsewhere ("plain", "plain"), as on the CPU"""
    if device.type == "cpu":
        return "plain", "plain"
    if device.type != "cuda":
        raise ValueError(f"film_layer_tp: no implementation for device {device}")
    if not fwd_kernel_fits(C, K, tp_hidden_pads(H, tp)[1]):
        return "plain", "plain"
    return "kernel", "kernel" if bwd_kernel_fits(C, K) else "plain"


def _tp_route(x, dw_kernel, H: int, tp: int) -> tuple[str, str]:
    return film_layer_tp_route(x.shape[-1], dw_kernel.shape[0], H, tp, x.device)


def film_tp_out_plain(buf, x, gate, g2, out_bias, H: int) -> torch.Tensor:
    """the plain version of K2's TP finish on the summed workspace"""
    return film_out(x, tp_out_plain(buf, x.shape, out_bias, H, x.dtype), gate, g2)


def film_layer_tp_partial(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                          out_kernel, H: int, tp: int):
    """the TP form's first phase on this rank's slice (the K2 TP form or its
    plain version, as ``film_layer_tp_route`` says) -> (the flat f32
    workspace to sum over the model group, the conv output y for the
    backward: the kernel's, None in the plain version, which recomputes
    it)"""
    if _tp_route(x, dw_kernel, H, tp)[0] == "kernel":
        return film_layer_tp_partial_cuda(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias,
                                          vg_kernel, vg_bias, out_kernel, H, tp)
    return film_layer_tp_partial_plain(x, scale, shift, g1, dw_kernel, dw_bias, vg_kernel,
                                       vg_bias, out_kernel), None


def film_layer_tp_partial_plain(x, scale, shift, g1, dw_kernel, dw_bias, vg_kernel, vg_bias,
                                out_kernel) -> torch.Tensor:
    """the plain version of the K2 TP form's first phase (one slice, S 1)"""
    y = depthwise_conv(film_in(x, scale, shift, g1), dw_kernel, dw_bias)
    return tp_partial_plain(y, vg_kernel, vg_bias, out_kernel)


def film_layer_tp_finish(buf, x, gate, g2, out_bias, H: int, kernel: bool = False
                         ) -> torch.Tensor:
    """the TP form's second phase, on the summed workspace -> (B, L, C): the
    K2 TP form's where ``kernel`` (the forward took it), else its plain
    version"""
    if kernel:
        return film_layer_tp_finish_cuda(buf, x, gate, g2, out_bias, H)
    return film_tp_out_plain(buf, x, gate, g2, out_bias, H)


def film_layer_tp_bwd(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                      out_kernel, out_bias, grad_out, buf, y, H: int, tp: int):
    """the TP form's backward first phase (the K3 TP form where
    ``film_layer_tp_route`` says so and the forward kernel stored y, else the
    plain version) -> (this rank's dY partial (1, B L, C) f32 to sum over the
    model group, (d vg_kernel, d vg_bias, d out_kernel) of the slice, (dgate,
    dg2, d out_bias), finish); ``finish()`` on the summed dY -> (dx, dscale,
    dshift, dg1, d dw_kernel, d dw_bias)"""
    if y is not None and _tp_route(x, dw_kernel, H, tp)[1] == "kernel":
        return film_layer_tp_bwd_cuda(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias,
                                      vg_kernel, vg_bias, out_kernel, out_bias, grad_out, buf, y,
                                      H, tp)
    return film_layer_tp_bwd_plain(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel,
                                   vg_bias, out_kernel, out_bias, grad_out, buf, H)


def film_layer_tp_bwd_plain(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel,
                            vg_bias, out_kernel, out_bias, grad_out, buf, H: int):
    """the plain version of ``film_layer_tp_bwd``: autograd of the finish
    and of the slice's products, then of the pre-norm, FiLM and conv"""
    B, L, C = x.shape
    dbuf, dgate, dg2, dbout = grads_of(
        lambda b, gt, g, bo: film_tp_out_plain(b, x, gt, g, bo, H), (buf, gate, g2, out_bias),
        grad_out)
    y = depthwise_conv(film_in(x, scale, shift, g1), dw_kernel, dw_bias)
    dy, *slice_grads = tp_slice_grads(y, vg_kernel, vg_bias, out_kernel,
                                      *tp_workspace_grads(dbuf, B * L, C))
    dy = dy.reshape(1, B * L, C)

    def finish():
        dx, dscale, dshift, dg1, ddw, ddwb = grads_of(
            lambda *t: depthwise_conv(film_in(*t[:4]), *t[4:]),
            (x, scale, shift, g1, dw_kernel, dw_bias), dy.sum(0).view(B, L, C).to(x.dtype))
        return dx + grad_out, dscale, dshift, dg1, ddw, ddwb

    return dy, tuple(slice_grads), (dgate, dg2, dbout), finish


def film_layer_tp_partial_cuda(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel,
                               vg_bias, out_kernel, H: int, tp: int):
    """K2 TP phase 0, csrc/film_layer.cu ``odt_film_layer_fwd_tp``: the core in
    the backward's first-pass mode over this rank's slice (y stored)"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                     out_kernel.new_empty(x.shape[-1]))
    B, L, C = x.shape
    K = dw_kernel.shape[0]
    if film_layer_tp_route(C, K, H, tp, x.device)[0] != "kernel":
        raise ValueError(f"the K2 TP form does not take C {C}, {K} taps, "
                         f"{tp_hidden_pads(H, tp)[1]} hidden units a rank (fwd_kernel_fits)")
    film = _film_inputs(x, scale, shift, gate, g1, g2)
    pack = packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, x.dtype)
    _, S = tp_fwd_plan(B * L, C, H, tp, device_sms(x.device), film=True)
    buf, ws, ss, fold = tp_workspace(S, B * L, C, x.device)
    y = torch.empty_like(x)
    run("odt_film_layer_fwd_tp", "film_layer_tp", x.device,
        x.data_ptr(), *(t.data_ptr() for t in film),
        pack.dww.data_ptr(), pack.dwb.data_ptr(), pack.bvg.data_ptr(), None, pack.weight_maps(),
        None, y.data_ptr(), ws.data_ptr(), ss.data_ptr(), fold,
        B, L, C, pack.H, pack.Hp, H, K, S, 0)
    return buf, y


def film_layer_tp_finish_cuda(buf, x, gate, g2, out_bias, H: int) -> torch.Tensor:
    """K2 TP phase 1: the reduction kernel with K2's epilogue over the summed
    workspace"""
    B, L, C = x.shape
    ws, ss = split_partials(buf, B * L, C)
    gate, g2 = (t.to(x.dtype).contiguous() for t in (gate, g2))
    out, bout = torch.empty_like(x), out_bias.to(x.dtype).contiguous()
    run("odt_film_layer_fwd_tp", "film_layer_tp", x.device,
        x.data_ptr(), None, None, gate.data_ptr(), None, g2.data_ptr(), None, None, None,
        bout.data_ptr(), None, out.data_ptr(), None, ws.data_ptr(), ss.data_ptr(), None,
        B, L, C, 0, 0, H, 0, ws.shape[0], 1, count=False)
    return out


def film_layer_tp_bwd_cuda(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel,
                           vg_bias, out_kernel, out_bias, grad_out, buf, y, H: int, tp: int):
    """K3 TP, csrc/film_layer_bwd.cu ``odt_film_layer_bwd_tp``: phase 0 (the
    row statistics and the block norm's backward from the forward's summed
    workspace, pass B on the slice, the slice's weight products); ``finish``
    runs phase 1 on the summed dY"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    B, L, C = x.shape
    K, BL, dev = dw_kernel.shape[0], B * L, x.device
    if film_layer_tp_route(C, K, H, tp, dev) != ("kernel", "kernel"):
        raise ValueError(f"the K3 TP form does not take C {C}, {K} taps (C one of "
                         f"{BWD_WIDTHS}, fwd_kernel_fits at {tp_hidden_pads(H, tp)[1]} units)")
    check_cuda("y", y, torch.bfloat16, 3)
    go = grad_out.to(torch.bfloat16).contiguous()
    film = _film_inputs(x, scale, shift, gate, g1, g2)
    pack = packed_ffn_weights(dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, x.dtype)
    bout = packed_out_bias(out_bias, vg_kernel, x.dtype)
    Hr, Hp = pack.H, pack.Hp
    nwg, sb = tp_bwd_plan(BL, C, H, tp, device_sms(dev), film=True)
    ws, ss = split_partials(buf, BL, C)
    nT = -(-L // _BM_ROWS)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    s_vg, s_out = gemm_splits(BL, C, 2 * Hp), gemm_splits(BL, Hp, C)
    dx = torch.empty_like(x)
    work = [torch.empty(BL, C, **bf),                                  # do
            torch.empty(BL, 2, **f32), torch.empty(B, nT, 3, C, **f32),  # (n, n^3 m), mid sums
            torch.empty(BL, 2 * Hp, **bf), torch.empty(BL, Hp, **bf),  # dvg, hn
            torch.empty(-(-BL // (64 * nwg)) * nwg, 2 * Hp, **f32),   # vg-bias partials
            *tp_dy(sb, BL, C, dev), torch.empty(B, nT, 4 + K, C, **f32),  # dY, finish sums
            torch.empty(s_vg, C, 2 * Hp, **f32), torch.empty(s_out, Hp, C, **f32),
            torch.empty(C, 2 * Hp, **f32), torch.empty(Hp, C, **f32)]  # dW_vg, dW_out
    args = [x.data_ptr(), go.data_ptr(), *(t.data_ptr() for t in film), pack.dww.data_ptr(),
            pack.dwb.data_ptr(), pack.bvg.data_ptr(), bout.data_ptr(), pack.weight_maps(),
            dx.data_ptr(), ws.data_ptr(), ss.data_ptr(), y.data_ptr(),
            *(t.data_ptr() for t in work), B, L, C, Hr, Hp, H, K, nwg, ws.shape[0], sb, s_vg, s_out]
    run("odt_film_layer_bwd_tp", "film_layer_bwd_tp", dev, *args, 0)
    mid, dbvg, dy, fin, dwvg, dwout = work[2], work[5], work[7], work[8], work[11], work[12]

    def finish(held=(x, go, film, pack, bout, buf, y, work)):
        """phase 1 (``held``: the tensors behind ``args``, alive until it
        has read them)"""
        run("odt_film_layer_bwd_tp", "film_layer_bwd_tp", dev, *args, 1, count=False)
        return (dx, *_fin_grads(fin))

    return dy, _ffn_grads(dbvg, dwvg, dwout, Hr, Hp), _mid_grads(mid), finish


class FilmLayerTPFunction(torch.autograd.Function):
    """the TP forms of one rank's slice, routed as ``film_layer_tp_route``
    says (on the card the K2 TP form forward, then the K3 TP form or the
    plain version backward), their partial sums all-reduced over the model
    group ``group`` between the phases; H the whole hidden width"""

    @staticmethod
    def forward(ctx, x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                out_kernel, out_bias, H, group):
        buf, y = film_layer_tp_partial(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias,
                                       vg_kernel, vg_bias, out_kernel, H, group_size(group))
        tp_all_reduce_(buf, group)
        ctx.save_for_backward(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel,
                              vg_bias, out_kernel, out_bias, buf, y)
        ctx.H, ctx.group = H, group
        return film_layer_tp_finish(buf, x, gate, g2, out_bias, H, y is not None)

    @staticmethod
    def backward(ctx, grad_out):
        *inputs, buf, y = ctx.saved_tensors
        dy, (dvgk, dvgb, doutk), (dgate, dg2, dbout), finish = film_layer_tp_bwd(
            *inputs, grad_out, buf, y, ctx.H, group_size(ctx.group))
        tp_all_reduce_(dy, ctx.group)
        dx, dscale, dshift, dg1, ddw, ddwb = finish()
        grads = (dx, dscale, dshift, dgate, dg1, dg2, ddw, ddwb, dvgk, dvgb, doutk, dbout)
        return (*(g.to(t.dtype) for g, t in zip(grads, inputs)), None, None)


def film_layer_tp(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
                  out_kernel, out_bias, H: int, group) -> torch.Tensor:
    """the film layer on a tensor-parallel rank holding a slice of the FFN's
    H hidden units: the TP forms routed as the one-rank op
    (``film_layer_tp_route``); the model group ``group`` sums the partials"""
    return FilmLayerTPFunction.apply(x, scale, shift, gate, g1, g2, dw_kernel, dw_bias,
                                     vg_kernel, vg_bias, out_kernel, out_bias, H, group)
