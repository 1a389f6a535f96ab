"""FiLM-modulated SwiGLU residual layer, forward: the plain PyTorch version
and the CUDA kernel.

Counterpart of osu_dreamer_tpu/ops/film_layer.py (``film_layer_reference``
and the Pallas ``_fwd_kernel``). Per position:

    h   = rms(x) * g1 * (1 + scale) + shift
    h   = SwiGLU(h)
    out = x + rms(h) * g2 * (1 + gate)

``film_layer`` dispatches by device: a CUDA tensor goes to the kernel in
``csrc/film_layer.cu`` (bf16 only; anything else raises), a CPU tensor to
``film_layer_plain``.
"""

from __future__ import annotations

import torch

from ..nn.norm import rms_norm
from ._build import check_cuda, run
from .swiglu import check_ffn_shapes, pack_ffn_weights, swiglu_plain


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


def film_layer_cuda(
    x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias,
) -> torch.Tensor:
    """the csrc/film_layer.cu kernel: bf16 (B, L, C) -> (B, L, C)"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    B, L, C = x.shape
    K = dw_kernel.shape[0]
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
    weights, H, Hp = pack_ffn_weights(
        dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias, dt
    )
    out = torch.empty_like(x)
    run(
        "odt_film_layer_fwd", "film_layer", x.device,
        x.data_ptr(), *(t.data_ptr() for t in film + gains + weights), out.data_ptr(),
        B, L, C, H, Hp, K,
    )
    return out


def film_layer(
    x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias,
) -> torch.Tensor:
    """film layer forward: kernel for CUDA tensors, plain version for CPU tensors"""
    args = (x, scale, shift, gate, g1, g2, dw_kernel, dw_bias, vg_kernel, vg_bias,
            out_kernel, out_bias)
    if x.is_cuda:
        return film_layer_cuda(*args)
    if x.device.type != "cpu":
        raise ValueError(f"film_layer: no implementation for device {x.device}")
    return film_layer_plain(*args)
