"""SwiGLU conv-FFN forward: the plain PyTorch version and the CUDA kernel.

Counterpart of osu_dreamer_tpu/ops/swiglu.py (``swiglu_reference`` and the
Pallas forward ``_kernel``). The block is

    x -> depthwise conv (2r+1 taps, zero SAME padding) -> (C, 2H) projection
      -> v * silu(g) -> RMS norm over H (f32 statistics) -> (H, C) projection

``swiglu`` dispatches by device: a CUDA tensor goes to the kernel in
``csrc/swiglu.cu`` (bf16 only; anything else raises), a CPU tensor to
``swiglu_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.norm import rms_norm
from ._build import check_cuda, run


def swiglu_plain(
    x: torch.Tensor,            # (B, L, C)
    dw_kernel: torch.Tensor,    # (K, C)
    dw_bias: torch.Tensor,      # (C,)
    vg_kernel: torch.Tensor,    # (C, 2H)
    vg_bias: torch.Tensor,      # (2H,)
    out_kernel: torch.Tensor,   # (H, C)
    out_bias: torch.Tensor,     # (C,)
) -> torch.Tensor:
    """every op in x's dtype, in the JAX reference's order"""
    dt = x.dtype
    K, L = dw_kernel.shape[0], x.shape[1]
    r = K // 2
    xp = F.pad(x, (0, 0, r, r))
    y = sum(xp[:, k : k + L] * dw_kernel[k].to(dt) for k in range(K)) + dw_bias.to(dt)
    vg = y @ vg_kernel.to(dt) + vg_bias.to(dt)
    v, g = vg.chunk(2, dim=-1)
    h = rms_norm(v * F.silu(g))
    return h @ out_kernel.to(dt) + out_bias.to(dt)


def pack_ffn_weights(
    dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias, dtype: torch.dtype
) -> tuple[list[torch.Tensor], int, int]:
    """cast the SwiGLU weights to ``dtype`` and zero-pad the hidden width H to
    a multiple of 16 (the wmma tile) -> (weights, H, padded H), laid out as
    csrc/ffn_tile.cuh expects: v columns then g columns, each padded"""
    C, H2 = vg_kernel.shape
    H = H2 // 2
    Hp = -(-H // 16) * 16
    dev = vg_kernel.device
    wvg = torch.zeros(C, 2 * Hp, dtype=dtype, device=dev)
    wvg[:, :H] = vg_kernel[:, :H]
    wvg[:, Hp : Hp + H] = vg_kernel[:, H:]
    bvg = torch.zeros(2 * Hp, dtype=dtype, device=dev)
    bvg[:H] = vg_bias[:H]
    bvg[Hp : Hp + H] = vg_bias[H:]
    wout = torch.zeros(Hp, C, dtype=dtype, device=dev)
    wout[:H] = out_kernel
    weights = [
        dw_kernel.to(dtype).contiguous(), dw_bias.to(dtype).contiguous(),
        wvg, bvg, wout, out_bias.to(dtype).contiguous(),
    ]
    return weights, H, Hp


def check_ffn_shapes(x: torch.Tensor, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                     out_bias) -> None:
    """raise unless the SwiGLU weights fit (B, L, C) input x as the kernels
    read them"""
    C = x.shape[-1]
    K, H = dw_kernel.shape[0], out_kernel.shape[0]
    if C % 16:
        raise ValueError(f"channels {C} must be a multiple of 16")
    if K % 2 == 0:
        raise ValueError(f"depthwise width {K} must be odd")
    shapes = {"dw_kernel": (dw_kernel, (K, C)), "dw_bias": (dw_bias, (C,)),
              "vg_kernel": (vg_kernel, (C, 2 * H)), "vg_bias": (vg_bias, (2 * H,)),
              "out_kernel": (out_kernel, (H, C)), "out_bias": (out_bias, (C,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the input on {x.device}")


def swiglu_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias) -> torch.Tensor:
    """the csrc/swiglu.cu kernel: bf16 (B, L, C) -> (B, L, C)"""
    check_cuda("x", x, torch.bfloat16, 3)
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    B, L, C = x.shape
    K = dw_kernel.shape[0]
    weights, H, Hp = pack_ffn_weights(
        dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias, x.dtype
    )
    out = torch.empty_like(x)
    run(
        "odt_swiglu_fwd", "swiglu", x.device,
        x.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(),
        B, L, C, H, Hp, K,
    )
    return out


def swiglu(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias) -> torch.Tensor:
    """SwiGLU forward: kernel for CUDA tensors, plain version for CPU tensors"""
    if x.is_cuda:
        return swiglu_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    if x.device.type != "cpu":
        raise ValueError(f"swiglu: no implementation for device {x.device}")
    return swiglu_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
