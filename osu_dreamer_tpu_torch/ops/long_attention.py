"""Softmax attention forward over normed and rotated q/k/v: the plain
PyTorch version and the CUDA flash kernel.

Counterpart of osu_dreamer_tpu/ops/long_attention.py
(``long_flash_attention`` and its XLA reference ``_xla_reference``): inputs
(B, L, H, D), output packed (B, L, H*D); logits and softmax in f32, the
probability matmul in the input dtype.

``long_flash_attention`` dispatches by device: a CUDA tensor goes to a
kernel (bf16, any head dim and length): ``csrc/flash_attention.cu`` at head
dims 32, 64 and 128 (``TEMPLATED_HEAD_DIMS``, one instantiation each), the
streamed ``csrc/attention_stream.cu`` at every other (q, k and v padded to a
multiple of 8 columns where TMA cannot map the head stride); a CPU tensor
goes to ``attention_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_cuda, run

# the head dims csrc/flash_attention.cu (and fused_attention.cu's resident
# kernels) are instantiated for; every other runs on csrc/attention_stream.cu
TEMPLATED_HEAD_DIMS = (32, 64, 128)


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


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """the csrc/flash_attention.cu kernel, or csrc/attention_stream.cu's at
    other head dims"""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(name, t, torch.bfloat16, 4)
    if not q.shape == k.shape == v.shape or not q.device == k.device == v.device:
        raise ValueError(f"q/k/v differ: shapes {q.shape}, {k.shape}, {v.shape}, "
                         f"devices {q.device}, {k.device}, {v.device}")
    B, L, H, D = q.shape
    out = torch.empty(B, L, H * D, dtype=q.dtype, device=q.device)
    if D in TEMPLATED_HEAD_DIMS:
        run(
            "odt_flash_attention_fwd", "flash_attention", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, D, D**-0.5,
        )
        return out
    Dp = stream_dim(D)
    if Dp != D:
        q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    run(
        "odt_attention_stream_fwd", "flash_attention", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, L, H, D, Dp, D**-0.5,
    )
    return out


def long_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """attention forward: kernel for CUDA tensors, plain version for CPU tensors"""
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "long_flash_attention has no backward kernel: training runs only at lengths "
                "where ops.fused_attention.fused_attention_fits holds"
            )
        return attention_cuda(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"long_flash_attention: no implementation for device {q.device}")
    return attention_plain(q, k, v)
