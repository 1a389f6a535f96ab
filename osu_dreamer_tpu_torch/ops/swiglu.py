"""SwiGLU conv-FFN forward and backward: the plain PyTorch versions and the
CUDA kernels.

Counterpart of osu_dreamer_tpu/ops/swiglu.py (``swiglu_reference``, the
Pallas forward ``_kernel``, the full backward ``_bwd_kernel`` and the partial
backward ``_partial_bwd_kernel``). The block is

    x -> depthwise conv (2r+1 taps, zero SAME padding) -> (C, 2H) projection
      -> v * silu(g) -> RMS norm over H (f32 statistics) -> (H, C) projection

``swiglu`` dispatches by device: a CUDA tensor goes to a
``torch.autograd.Function`` whose forward is the kernel in ``csrc/swiglu.cu``
(K4) and whose backward is chosen as the JAX ``_bwd`` chooses it: where
``bwd_kernel_feasible`` holds, ``odt_swiglu_bwd_full`` in
``csrc/swiglu_bwd.cu`` (K5, every weight gradient in the call), elsewhere
``odt_swiglu_bwd`` (K6) plus the two big weight products as torch matmuls
(bf16 only; anything else raises); a CPU tensor to ``swiglu_plain``,
differentiated by autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.norm import rms_norm
from ._build import check_cuda, run

# extended rows per block of the backward kernel (csrc/swiglu_bwd.cu kSbE):
# each block owns BWD_ROWS - 2r core rows
BWD_ROWS = 80
# the split-K chunks of csrc/gemm_tn.cuh's weight products: enough (output
# tile, chunk) blocks to fill the card's 132 SMs about four times
_GEMM_BLOCKS = 4 * 132

# The JAX dispatch rule between the full backward (K5) and the partial one
# (K6), copied from osu_dreamer_tpu/ops/swiglu.py (``_bwd_vmem_bytes``,
# ``bwd_kernel_feasible``) and ops/_tiles.py (the budget and the halving
# search), so both packages take K5 at the same dims. It is the rule that
# chooses the backward, not a tile size of the CUDA kernels.
_HALO = 8
_DEFAULT_TILE = 512
_VMEM_BUDGET_BYTES = 14 * 2**20


def _bwd_vmem_bytes(C: int, H: int, K: int, tile: int) -> int:
    E = tile + 2 * _HALO
    weights = 2 * (K * C + C + C * 2 * H + 2 * H + H * C)
    accums = 4 * (K * C + C + C * 2 * H + 2 * H + H * C + C)
    work = 4 * E * (2 * H) * 3 + 4 * E * H * 2 + 4 * E * C * 2 + 2 * E * C * 2
    return weights + accums + work


def bwd_kernel_feasible(C: int, H: int, K: int) -> bool:
    """whether the JAX package takes its full-accumulator backward at these
    dims: some power-of-two halving of its default tile down to 64 fits the
    budget"""
    tile = _DEFAULT_TILE
    while tile > 64 and _bwd_vmem_bytes(C, H, K, tile) > _VMEM_BUDGET_BYTES:
        tile //= 2
    return _bwd_vmem_bytes(C, H, K, tile) <= _VMEM_BUDGET_BYTES


def gemm_splits(rows: int, m: int, n: int) -> int:
    """split-K chunk count of csrc/gemm_tn.cuh for a (m, n) product over rows"""
    tiles = -(-m // 64) * -(-n // 64)
    return max(1, min(rows // 16, -(-_GEMM_BLOCKS // tiles)))


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


def swiglu_bwd_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """autograd of ``swiglu_plain`` -> (dx, d dw_kernel, d dw_bias,
    d vg_kernel, d vg_bias, d out_kernel, d out_bias), the tuple the JAX
    ``_fused_swiglu_partial_bwd_impl`` returns"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in
                  (x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel)]
        out_bias = out_kernel.new_zeros(out_kernel.shape[1]).requires_grad_()
        y = swiglu_plain(*leaves, out_bias)
        return torch.autograd.grad(y, [*leaves, out_bias], grad_out)


def _bwd_inputs(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """the backward kernels' checks -> (bf16 output gradient, packed
    weights, H, padded H)"""
    check_cuda("x", x, torch.bfloat16, 3)
    out_bias = vg_kernel.new_zeros(x.shape[-1])
    check_ffn_shapes(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
    go = grad_out.to(torch.bfloat16).contiguous()
    if x.shape[-1] % 32 or x.shape[-1] > 512:
        raise ValueError(f"channels {x.shape[-1]} must be a multiple of 32 and at most 512 for "
                         "the backward kernels")
    if go.shape != x.shape or go.device != x.device:
        raise ValueError(f"grad_out must be {tuple(x.shape)} on {x.device}, "
                         f"got {tuple(go.shape)} on {go.device}")
    weights, H, Hp = pack_ffn_weights(
        dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias, x.dtype
    )
    return go, weights, H, Hp


def swiglu_bwd_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """K6, csrc/swiglu_bwd.cu: dx (bf16) and the small gradients (f32) from
    the kernel; dW_vg = y^T dvg and dW_out = hn^T go as f32-accumulated
    torch matmuls over all B*L rows. -> the tuple of ``swiglu_bwd_plain``,
    weight gradients f32"""
    go, weights, H, Hp = _bwd_inputs(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                                     grad_out)
    B, L, C = x.shape
    K = dw_kernel.shape[0]
    rows = BWD_ROWS - 2 * (K // 2)
    nblk = B * -(-L // rows)
    dev = x.device
    dx, y = torch.empty_like(x), torch.empty_like(x)
    dvg = torch.empty(B, L, 2 * H, dtype=x.dtype, device=dev)
    hn = torch.empty(B, L, H, dtype=x.dtype, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    ddw, ddwb = torch.empty(nblk, K, C, **f32), torch.empty(nblk, C, **f32)
    dbvg, dbout = torch.empty(nblk, 2 * Hp, **f32), torch.empty(nblk, C, **f32)
    scratch = torch.empty(nblk, BWD_ROWS, 2 * Hp, dtype=x.dtype, device=dev)  # dvg of each block
    run(
        "odt_swiglu_bwd", "swiglu_bwd", dev,
        x.data_ptr(), go.data_ptr(), *(w.data_ptr() for w in weights[:5]),
        *(t.data_ptr() for t in (dx, dvg, hn, y, ddw, ddwb, dbvg, dbout, scratch)),
        B, L, C, H, Hp, K,
    )
    dwvg = torch.mm(y.reshape(-1, C).t(), dvg.reshape(-1, 2 * H), out_dtype=torch.float32)
    dwout = torch.mm(hn.reshape(-1, H).t(), go.reshape(-1, C), out_dtype=torch.float32)
    dbvg = dbvg.sum(0)
    return (dx, ddw.sum(0), ddwb.sum(0), dwvg, torch.cat([dbvg[:H], dbvg[Hp : Hp + H]]), dwout,
            dbout.sum(0))


def swiglu_bwd_full_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, grad_out):
    """K5, csrc/swiglu_bwd.cu ``odt_swiglu_bwd_full``: K6's row pass, then
    both weight products (split-K, fixed order) and the sums of the small
    gradients' per-block partials in the same call. -> the tuple of
    ``swiglu_bwd_plain``, dx bf16 and the weight gradients f32"""
    go, weights, H, Hp = _bwd_inputs(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                                     grad_out)
    B, L, C = x.shape
    K = dw_kernel.shape[0]
    nblk = B * -(-L // (BWD_ROWS - 2 * (K // 2)))
    R = nblk * BWD_ROWS
    dev = x.device
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    s_vg, s_out = gemm_splits(R, C, 2 * Hp), gemm_splits(R, Hp, C)
    dx = torch.empty_like(x)
    parts = [torch.empty(nblk, K, C, **f32), torch.empty(nblk, C, **f32),
             torch.empty(nblk, 2 * Hp, **f32), torch.empty(nblk, C, **f32)]
    scratch = [torch.empty(R, 2 * Hp, **bf), torch.empty(R, C, **bf), torch.empty(R, Hp, **bf),
               torch.empty(R, C, **bf)]  # dvg, y, hn, go
    pvg, pout = torch.empty(s_vg, C, 2 * Hp, **f32), torch.empty(s_out, Hp, C, **f32)
    ddw, ddwb, dbvg, dbout = (torch.empty(K, C, **f32), torch.empty(C, **f32),
                              torch.empty(2 * Hp, **f32), torch.empty(C, **f32))
    dwvg, dwout = torch.empty(C, 2 * Hp, **f32), torch.empty(Hp, C, **f32)
    run(
        "odt_swiglu_bwd_full", "swiglu_bwd_full", dev,
        x.data_ptr(), go.data_ptr(), *(w.data_ptr() for w in weights[:5]), dx.data_ptr(),
        *(t.data_ptr() for t in parts + scratch + [pvg, pout, ddw, ddwb, dbvg, dbout, dwvg, dwout]),
        B, L, C, H, Hp, K, s_vg, s_out,
    )
    return (dx, ddw, ddwb, torch.cat([dwvg[:, :H], dwvg[:, Hp : Hp + H]], 1),
            torch.cat([dbvg[:H], dbvg[Hp : Hp + H]]), dwout[:H], dbout)


class SwiGLUFunction(torch.autograd.Function):
    """K4 forward; K5 backward where the JAX dispatch takes its full
    backward (``bwd_kernel_feasible``), K6 elsewhere"""

    @staticmethod
    def forward(ctx, x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias):
        ctx.save_for_backward(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel)
        return swiglu_cuda(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)

    @staticmethod
    def backward(ctx, grad_out):
        x, *weights = ctx.saved_tensors
        C, H, K = x.shape[-1], weights[4].shape[0], weights[0].shape[0]
        bwd = swiglu_bwd_full_cuda if bwd_kernel_feasible(C, H, K) else swiglu_bwd_cuda
        grads = bwd(x, *weights, grad_out)
        return (grads[0].to(x.dtype),
                *(g.to(w.dtype) for g, w in zip(grads[1:], (*weights, weights[-1]))))


def swiglu(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias) -> torch.Tensor:
    """SwiGLU: kernels (forward and backward) for CUDA tensors, the plain
    version (autograd) for CPU tensors"""
    if x.is_cuda:
        return SwiGLUFunction.apply(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel,
                                    out_bias)
    if x.device.type != "cpu":
        raise ValueError(f"swiglu: no implementation for device {x.device}")
    return swiglu_plain(x, dw_kernel, dw_bias, vg_kernel, vg_bias, out_kernel, out_bias)
