"""Per-head RMS norm and RoPE of q and k ahead of the long attention route,
forward and backward: the plain PyTorch version and the CUDA passes.

Counterpart of the JAX package's ``rope(rms_norm(q, q_gamma))`` and
``rope(rms_norm(k, k_gamma))`` before ``long_flash_attention``
(osu_dreamer_tpu/nn/attention.py), which XLA fuses: packed (B, L, 3*H*D) ->
q, k, v, each (B, L, H, D), q and k normalised with their gains (f32
statistics, eps 1e-6, bf16 values times bf16 gains) and rotated (bf16
rotary products), v as it lies.

``norm_rope_qkv`` dispatches by device: a CUDA tensor goes to the streamed
attention's own passes (csrc/attention_stream.cu), one each way:
``odt_qk_prep``, K9's prep pass, writes q, k and v's copy; under autograd
``NormRopeQKV``, whose backward ``odt_qk_post``, K10's post pass, takes dq,
dk and dv where they lie into packed dqkv and the gains' partials, summed
here in a fixed order. A CPU tensor goes to ``norm_rope_qkv_plain``,
differentiated by autograd.
"""

from __future__ import annotations

import torch

from ..nn.norm import rms_norm
from ._build import run
from .fused_attention import POST_CHUNK, _check_kernel_shapes, _kernel_inputs, needs_grad, rope


def norm_rope_qkv_plain(qkv: torch.Tensor, q_gamma: torch.Tensor, k_gamma: torch.Tensor,
                        n_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """packed (B, L, 3*H*D) -> q, k, v (B, L, H, D): the torch chain in
    qkv's dtype"""
    B, L, _ = qkv.shape
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    q = rope(rms_norm(q.reshape(B, L, n_heads, -1), q_gamma))
    k = rope(rms_norm(k.reshape(B, L, n_heads, -1), k_gamma))
    return q, k, v.reshape(B, L, n_heads, -1).contiguous()


def qk_prep_cuda(qkv, q_gamma, k_gamma, n_heads):
    """csrc/attention_stream.cu ``odt_qk_prep``: bf16 packed qkv -> q, k, v as
    ``norm_rope_qkv_plain`` returns them"""
    B, L, H, D = _check_kernel_shapes(qkv, n_heads)
    cos, sin, gq, gk = _kernel_inputs(qkv, q_gamma, k_gamma, L, D)
    q, k, v = (torch.empty(B, L, H, D, dtype=torch.bfloat16, device=qkv.device)
               for _ in range(3))
    run("odt_qk_prep", "qk_prep", qkv.device,
        *(t.data_ptr() for t in (qkv, gq, gk, cos, sin, q, k, v)), B, L, H, D)
    return q, k, v


def _row_strides(name: str, t: torch.Tensor, shape) -> tuple[torch.Tensor, int, int]:
    """``t`` (B, L, H, D) bf16 on the card, copied unless its columns are
    contiguous and its (B, L) rows one stride apart -> (t, row stride, head
    stride) in elements"""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    t = t.to(torch.bfloat16)
    sb, sl, sh, sd = t.stride()
    if sd != 1 or sb != shape[1] * sl:
        t = t.contiguous()
        sb, sl, sh, sd = t.stride()
    return t, sl, sh


def qk_post_cuda(qkv, dq, dk, dv, q_gamma, k_gamma, n_heads):
    """csrc/attention_stream.cu ``odt_qk_post``: dq, dk, dv (B, L, H, D),
    each at any row and head strides -> (dqkv bf16, dq_gamma f32, dk_gamma
    f32); the gains' partials (one per POST_CHUNK rows, q's and k's in one
    array) summed here"""
    B, L, H, D = _check_kernel_shapes(qkv, n_heads)
    cos, sin, gq, gk = _kernel_inputs(qkv, q_gamma, k_gamma, L, D)
    grads = [_row_strides(name, t, (B, L, H, D)) for name, t in (("dq", dq), ("dk", dk),
                                                                  ("dv", dv))]
    for name, (t, _, _) in zip(("dq", "dk", "dv"), grads):
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
    dqkv = torch.empty_like(qkv)
    dg = torch.empty(-(-B * L // POST_CHUNK), 2, D, dtype=torch.float32, device=qkv.device)
    run("odt_qk_post", "qk_post", qkv.device,
        *(t.data_ptr() for t in (qkv, gq, gk, cos, sin)), *(t.data_ptr() for t, _, _ in grads),
        *(s for _, sl, sh in grads for s in (sl, sh)), dqkv.data_ptr(), dg.data_ptr(),
        B, L, H, D)
    dq_gamma, dk_gamma = dg.sum(0)
    return dqkv, dq_gamma, dk_gamma


def qk_post_plain(qkv, dq, dk, dv, q_gamma, k_gamma, n_heads):
    """the backward kernel's (dqkv, dq_gamma, dk_gamma) in plain PyTorch:
    autograd through ``norm_rope_qkv_plain``"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (qkv, q_gamma, k_gamma)]
        return torch.autograd.grad(norm_rope_qkv_plain(*leaves, n_heads), leaves, (dq, dk, dv))


class NormRopeQKV(torch.autograd.Function):
    """the forward pass, and the backward pass into packed dqkv; its own
    node of the autograd graph, apart from the attention's"""

    @staticmethod
    def forward(ctx, qkv, q_gamma, k_gamma, n_heads):
        ctx.save_for_backward(qkv, q_gamma, k_gamma)
        ctx.n_heads = n_heads
        return qk_prep_cuda(qkv, q_gamma, k_gamma, n_heads)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        qkv, q_gamma, k_gamma = ctx.saved_tensors
        dqkv, dgq, dgk = qk_post_cuda(qkv, dq, dk, dv, q_gamma, k_gamma, ctx.n_heads)
        return dqkv, dgq.to(q_gamma.dtype), dgk.to(k_gamma.dtype), None


def norm_rope_qkv(qkv: torch.Tensor, q_gamma: torch.Tensor, k_gamma: torch.Tensor,
                  n_heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """packed (B, L, 3*H*D) -> q, k, v (B, L, H, D), q and k normalised and
    rotated: the passes for CUDA tensors (``NormRopeQKV`` when a gradient
    will be taken, else the forward alone), the plain version (autograd) for
    CPU tensors"""
    if qkv.is_cuda:
        if needs_grad(qkv, q_gamma, k_gamma):
            return NormRopeQKV.apply(qkv, q_gamma, k_gamma, n_heads)
        return qk_prep_cuda(qkv, q_gamma, k_gamma, n_heads)
    if qkv.device.type != "cpu":
        raise ValueError(f"norm_rope_qkv: no implementation for device {qkv.device}")
    return norm_rope_qkv_plain(qkv, q_gamma, k_gamma, n_heads)
