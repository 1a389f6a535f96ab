"""Softmax attention over normed and rotated q/k/v, forward and backward:
the plain PyTorch version and the CUDA kernels.

Counterpart of osu_dreamer_tpu/ops/long_attention.py
(``long_flash_attention``, its XLA reference ``_xla_reference`` and the
``custom_vjp`` whose backward differentiates that reference): inputs
(B, L, H, D), output packed (B, L, H*D); logits and softmax in f32, the
probability matmul in the input dtype.

``long_flash_attention`` dispatches by device. A CUDA tensor goes to a
kernel (bf16, any head dim and length). Where no gradient will be taken:
``csrc/flash_attention.cu`` at head dims 32, 64 and 128
(``TEMPLATED_HEAD_DIMS``, one instantiation each), the streamed
``csrc/attention_stream.cu`` at every other (q, k and v padded to a
multiple of 8 columns where TMA cannot map the head stride). Under
autograd, ``LongFlashAttention``: the streamed forward at every head dim,
writing the f32 log-sum-exp of each query row, and a hand-written backward:
``csrc/long_attention_bwd.cu`` (a delta pass, then one pass that forms S
and dP once per tile pair and writes dq, dk and dv in bf16) where the
padded head dim is at most ``ONE_PASS_DIM``, else ``odt_attention_stream_bwd``
(a delta pass, then the dK/dV and dQ launches of the streamed K10). A CPU
tensor goes to ``attention_plain``, differentiated by autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_cuda, run

# the head dims csrc/flash_attention.cu (and fused_attention.cu's resident
# kernels) are instantiated for; every other runs on csrc/attention_stream.cu
TEMPLATED_HEAD_DIMS = (32, 64, 128)
# the widest padded head dim csrc/long_attention_bwd.cu takes: its dK and dV
# of 64 keys a warpgroup beside S^T and dP^T fill a consumer's registers
ONE_PASS_DIM = 128


def stream_dim(D: int) -> int:
    """the padded head dim of the streamed kernels' (B, L, H, Dp) operands:
    D rounded up to 8 (a TMA row stride is a multiple of 16 bytes)"""
    return -(-D // 8) * 8


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, H*D); f32 logits and softmax, P @ V in q's dtype"""
    B, L, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / D**0.5
    p = s.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, L, H * D)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t, torch.bfloat16, 4)
    if not q.shape == k.shape == v.shape or not q.device == k.device == v.device:
        raise ValueError(f"q/k/v differ: shapes {q.shape}, {k.shape}, {v.shape}, "
                         f"devices {q.device}, {k.device}, {v.device}")


def _stream_inputs(q, k, v) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """q, k, v zero-padded to the streamed kernels' Dp columns (as they are
    where Dp == D) and Dp"""
    D = q.shape[-1]
    Dp = stream_dim(D)
    if Dp != D:
        q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    return q, k, v, Dp


def _stream_fwd(q, k, v, D: int, Dp: int, lse: torch.Tensor | None) -> torch.Tensor:
    """the streamed forward over (B, L, H, Dp) rows of head dim D; lse (B, H,
    L) f32 is written where given"""
    B, L, H, _ = q.shape
    out = torch.empty(B, L, H * D, dtype=q.dtype, device=q.device)
    run(
        "odt_attention_stream_fwd", "flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, L, H, D, Dp, D**-0.5,
    )
    return out


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """the csrc/flash_attention.cu kernel, or csrc/attention_stream.cu's at
    other head dims"""
    _check_qkv(q, k, v)
    B, L, H, D = q.shape
    if D in TEMPLATED_HEAD_DIMS:
        out = torch.empty(B, L, H * D, dtype=q.dtype, device=q.device)
        run(
            "odt_flash_attention_fwd", "flash_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, D, D**-0.5,
        )
        return out
    qp, kp, vp, Dp = _stream_inputs(q, k, v)
    return _stream_fwd(qp, kp, vp, D, Dp, None)


def attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """the forward a gradient will be taken of: the streamed kernel at every
    head dim -> (out (B, L, H*D), lse (B, H, L) f32, and q, k, v as it read
    them: padded to Dp columns, the backward's operands)"""
    _check_qkv(q, k, v)
    B, L, H, D = q.shape
    qp, kp, vp, Dp = _stream_inputs(q, k, v)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    return _stream_fwd(qp, kp, vp, D, Dp, lse), lse, (qp, kp, vp)


def attention_bwd_cuda(q, k, v, out, lse, grad, D: int):
    """the long attention backward: q, k, v (B, L, H, Dp) as
    ``attention_fwd_cuda`` returns them, its out and lse, grad (B, L, H*D)
    -> (dq, dk, dv), each (B, L, H, D) bf16. At Dp <= ONE_PASS_DIM
    csrc/long_attention_bwd.cu ``odt_long_attention_bwd`` writes all three
    into one packed (B, L, 3 H De) buffer (De = D rounded up to even), of
    which they are views; past it csrc/attention_stream.cu
    ``odt_attention_stream_bwd`` writes dv there and dq and dk as f32 rows,
    cut to D and cast here"""
    _check_qkv(q, k, v)
    B, L, H, Dp = q.shape
    if Dp != stream_dim(D):
        raise ValueError(f"rows of {Dp} columns do not hold head dim {D}")
    grad = grad.to(torch.bfloat16).contiguous()
    for name, t, dtype, shape in (("grad", grad, torch.bfloat16, (B, L, H * D)),
                                  ("out", out, torch.bfloat16, (B, L, H * D)),
                                  ("lse", lse, torch.float32, (B, H, L))):
        check_cuda(name, t, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    dev = q.device
    delta = torch.empty(B, H, L, dtype=torch.float32, device=dev)
    rdo = None if Dp == D else torch.empty(B, L, H, Dp, dtype=torch.bfloat16, device=dev)
    De = D + D % 2
    dqkv = torch.empty(B, L, 3 * H * De, dtype=torch.bfloat16, device=dev)
    views = dqkv.view(B, L, 3, H, De)[..., :D].unbind(2)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), None if rdo is None else rdo.data_ptr())
    if Dp <= ONE_PASS_DIM:
        # per (batch row, head, 64-row query tile): the dQ accumulator's
        # 64 x (Dp rounded up to 64) f32 and its key-block counter
        tiles = B * H * -(-L // 64)
        acc = torch.empty(tiles * 64 * 64 * -(-Dp // 64), dtype=torch.float32, device=dev)
        counters = torch.empty(tiles, dtype=torch.int32, device=dev)
        run("odt_long_attention_bwd", "long_attention_bwd", dev, *common, acc.data_ptr(),
            counters.data_ptr(), dqkv.data_ptr(), B, L, H, D, Dp, D**-0.5)
        return views
    dq, dk = (torch.empty(B, L, H, Dp, dtype=torch.float32, device=dev) for _ in range(2))
    run("odt_attention_stream_bwd", "long_attention_bwd", dev, *common, dq.data_ptr(),
        dk.data_ptr(), dqkv.data_ptr(), B, L, H, D, Dp, D**-0.5)
    return dq[..., :D].to(torch.bfloat16), dk[..., :D].to(torch.bfloat16), views[2]


def attention_bwd_plain(q, k, v, grad):
    """the backward kernel's (dq, dk, dv) in plain PyTorch: autograd through
    ``attention_plain``, the counterpart of the JAX ``_vjp_bwd`` (the
    vjp of ``_xla_reference``)"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(attention_plain(*leaves), leaves, grad)


class LongFlashAttention(torch.autograd.Function):
    """the streamed forward writing lse, and the long attention backward"""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse, rows = attention_fwd_cuda(q, k, v)
        ctx.save_for_backward(*rows, out, lse)
        ctx.head_dim = q.shape[-1]
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        return attention_bwd_cuda(q, k, v, out, lse, grad, ctx.head_dim)


def long_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """attention: kernels for CUDA tensors (``LongFlashAttention`` when a
    gradient will be taken, else the forward alone, which writes no lse),
    the plain version (autograd) for CPU tensors"""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return LongFlashAttention.apply(q, k, v)
        return attention_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"long_flash_attention: no implementation for device {q.device}")
    return attention_plain(q, k, v)
