"""The precision the reference computes in.

``Numerics("f32")`` is the judge: every product in float32 with TF32 off.
``Numerics("fp8")`` is the control, the step below the configurations'
bf16 compute: the operands of every matrix product (dense layers,
attention's two products, the label projection, the spectrogram stem's
convolutions) are rounded to float8 e4m3 with one scale per tensor (its
largest magnitude mapped to 448), and under autograd the products of the
backward take their incoming gradient rounded to float8 e5m2 the same way
(largest magnitude 57344), as fp8 training does. Products accumulate in
float32; everything between them stays float32 in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def set_f32_matmul() -> None:
    """float32 products in float32, not TF32 (a process-wide setting)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """``t`` rounded to a float8 format with one scale for the tensor, back in float32"""
    t = t.detach().float()
    scale = t.abs().amax().clamp_min(1e-30) / fmt[1]
    return (t / scale).to(fmt[0]).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a (..., M, K) @ b (K, N) or (..., K, N), e4m3 operands; the backward's
    two products on the e5m2 gradient and the saved e4m3 operands"""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = fp8(grad, E5M2)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb


class Numerics:
    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "f32":
            return a.float() @ b.float()
        return _Fp8Matmul.apply(a.float(), b.float())

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """an operand of a forward-only product, as this precision holds it"""
        return t.float() if self.kind == "f32" else fp8(t)

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """forward only (the style prior's label projection)"""
        return torch.einsum(spec, self.q(a), self.q(b))

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
        """forward only (the spectrogram stem)"""
        return F.conv2d(self.q(x), self.q(w), stride=stride, padding=padding)
