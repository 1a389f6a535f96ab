"""Fused per-head RMS norm + RoPE + softmax attention straight off the packed
qkv projection, forward and backward: the plain PyTorch version and the CUDA
kernels.

Counterpart of osu_dreamer_tpu/ops/fused_attention.py
(``fused_attention_fits``, ``rope_attention_reference`` and the Pallas
``_fwd_kernel``/``_bwd_kernel``): packed (B, L, 3*H*D) -> (B, L, H*D). The
numerics are the plain path's: f32 norm statistics (eps 1e-6), bf16
normalised values times bf16 gamma, bf16 rotary multiplies, f32 logits and
softmax, the probability matmul in the input dtype.

``fused_norm_rope_attention`` dispatches by device: a CUDA tensor goes to the
``torch.autograd.Function`` whose forward is K9 and whose backward is K10,
bf16, at every shape the JAX gate admits: at head dims 32, 64 and 128 and
L <= 256 (``resident``) csrc/fused_attention.cu ``fused_attention_fwd_kernel``
and ``fused_attention_bwd_kernel`` (at head dim 128 the two launches
``fused_attention_bwd_kv_kernel`` and ``fused_attention_bwd_q_kernel``),
which hold a head's rows in shared memory; elsewhere the streamed kernels of
csrc/attention_stream.cu (a prep pass, the forward; the prep pass, the dK/dV
and dQ launches and a post pass); a CPU tensor to ``rope_attention_plain``,
differentiated by autograd.
The forward's one residual is the f32 log-sum-exp of each query row, written
only when a gradient will be taken; the backward normalises and rotates q
and k again from the raw rows with the forward's own code.
"""

from __future__ import annotations

import functools

import torch

from ..nn.norm import rms_norm
from ._build import check_cuda, run
from .long_attention import TEMPLATED_HEAD_DIMS, attention_plain, stream_dim
from .swiglu import _cached

# the JAX package's gate (its backward's VMEM budget), kept so both packages
# take the fused path at the same shapes
MAX_FUSED_LEN = 256
# the lengths csrc/fused_attention.cu's kernels hold in shared memory: a
# head's rows of q, k, v and dO, up to four 64-row tiles each
RESIDENT_LEN = 256
# rows a block of the streamed post pass (csrc/attention_stream.cu
# kStChunk): one gamma partial per chunk of rows, all heads
POST_CHUNK = 32


def fused_attention_fits(L: int, n_heads: int, head_dim: int) -> bool:
    """the JAX package's shape gate (copied): working set bounded by
    L * H * D, even rotary halves, packed head dim a multiple of 128"""
    HD = n_heads * head_dim
    return HD > 0 and L * HD <= MAX_FUSED_LEN * 1024 and head_dim % 2 == 0 and HD % 128 == 0


def attention_route(L: int, n_heads: int, head_dim: int) -> str:
    """where RoPE attention over L positions runs, decided before any launch
    and the same on every device type: "fused" (``fused_norm_rope_attention``:
    K9 forward, K10 backward on the card) exactly where the JAX gate
    ``fused_attention_fits`` holds, else "long" (norm and RoPE by
    ops/norm_rope.py, then ``long_flash_attention``: K7 on the card, and
    under autograd the streamed forward and the long attention backward).
    The kernels take every head dim and length, so no shape raises here"""
    return "fused" if fused_attention_fits(L, n_heads, head_dim) else "long"


def resident(L: int, head_dim: int) -> bool:
    """whether K9/K10 run on csrc/fused_attention.cu's kernels, which hold a
    head's rows in shared memory (head dims 32, 64, 128 and L <= 256), or on
    the streamed ones of csrc/attention_stream.cu"""
    return head_dim in TEMPLATED_HEAD_DIMS and L <= RESIDENT_LEN


def rope_tables(L: int, D: int, device, dtype: torch.dtype,
                offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (L, D/2) in ``dtype`` for positions ``offset`` ..
    ``offset + L - 1``: f32 angles rounded once"""
    inv_freq = 10000.0 ** (torch.arange(0, D, 2, dtype=torch.float32, device=device) / -D)
    positions = torch.arange(L, dtype=torch.float32, device=device) + offset
    angles = positions[:, None] * inv_freq[None, :]
    return angles.cos().to(dtype), angles.sin().to(dtype)


@functools.cache
def kernel_tables(L: int, D: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``rope_tables(L, D)`` in bf16 on ``device``, built once per (L, D,
    device): the first call, before any graph capture, makes them (one pair
    per length and head dim a run trains or samples at); the kernels only
    read them"""
    return rope_tables(L, D, device, torch.bfloat16)


def kernel_gammas(q_gamma: torch.Tensor, k_gamma: torch.Tensor,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """the two (D,) gains in bf16 on ``device``, once per version of the
    pair (the weight-pack cache of ops/swiglu.py, held by ``q_gamma``, so
    each replica's gains are packed on its own device)"""
    if q_gamma.dim() != 1 or k_gamma.shape != q_gamma.shape:
        raise ValueError(f"gammas must be two (D,) vectors, got {tuple(q_gamma.shape)}, "
                         f"{tuple(k_gamma.shape)}")
    return _cached("att_gammas", (q_gamma, k_gamma), torch.bfloat16, lambda: tuple(
        g.to(device=device, dtype=torch.bfloat16).contiguous() for g in (q_gamma, k_gamma)),
        owner=q_gamma)


def rope(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """rotary position embedding over (B, L, H, D) with even D; ``offset``
    shifts the positions (a sequence-parallel shard's global index)"""
    _, L, _, D = x.shape
    if D % 2:
        raise ValueError("head_dim must be even")
    cos, sin = rope_tables(L, D, x.device, x.dtype, offset)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _split_heads(qkv: torch.Tensor, n_heads: int):
    B, L, three_hd = qkv.shape
    HD = three_hd // 3
    if 3 * HD != three_hd or HD % n_heads:
        raise ValueError(f"packed width {three_hd} does not split into 3 x {n_heads} heads")
    return (t.reshape(B, L, n_heads, HD // n_heads) for t in qkv.split(HD, dim=-1))


def rope_attention_plain(qkv: torch.Tensor, q_gamma: torch.Tensor, k_gamma: torch.Tensor,
                         n_heads: int) -> torch.Tensor:
    """(B, L, 3*H*D) -> (B, L, H*D), the JAX ``rope_attention_reference``
    composition in qkv's dtype"""
    q, k, v = _split_heads(qkv, n_heads)
    return attention_plain(rope(rms_norm(q, q_gamma)), rope(rms_norm(k, k_gamma)), v)


def fused_attention_fwd_plain(qkv, q_gamma, k_gamma, n_heads):
    """the forward kernel's outputs in plain PyTorch: (out, lse) with lse
    (B, H, L) the f32 log-sum-exp of each query's scaled logits, the one
    residual the backward reads (it normalises and rotates q and k again)"""
    q, k, _ = _split_heads(qkv, n_heads)
    D = q.shape[-1]
    rq, rk = rope(rms_norm(q, q_gamma)), rope(rms_norm(k, k_gamma))
    s = torch.einsum("bqhd,bkhd->bhqk", rq.float(), rk.float()) / D**0.5
    return rope_attention_plain(qkv, q_gamma, k_gamma, n_heads), s.logsumexp(-1)


def fused_attention_bwd_plain(qkv, grad, out, lse, q_gamma, k_gamma, n_heads):
    """the backward kernel's outputs (dqkv, dq_gamma, dk_gamma) in plain
    PyTorch: autograd through ``rope_attention_plain`` (out and lse are
    accepted for the kernel's signature and not read)"""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (qkv, q_gamma, k_gamma)]
        y = rope_attention_plain(*leaves, n_heads)
        return torch.autograd.grad(y, leaves, grad)


def _check_kernel_shapes(qkv: torch.Tensor, n_heads: int) -> tuple[int, int, int, int]:
    check_cuda("qkv", qkv, torch.bfloat16, 3)
    B, L, three_hd = qkv.shape
    D = three_hd // (3 * n_heads)
    if three_hd % (3 * n_heads) or D % 2 or D == 0 or L == 0:
        raise ValueError(f"packed width {three_hd} at length {L} is not 3 x {n_heads} heads of "
                         "an even head dim")
    return B, L, n_heads, D


def _kernel_inputs(qkv, q_gamma, k_gamma, L: int, D: int):
    """the rotary tables and the bf16 gains on qkv's device"""
    dev = qkv.device
    cos, sin = kernel_tables(L, D, dev)
    gq, gk = kernel_gammas(q_gamma, k_gamma, dev)
    if gq.shape != (D,):
        raise ValueError(f"gammas {tuple(gq.shape)} do not match head dim {D}")
    return cos, sin, gq, gk


def _stream_rows(B: int, L: int, H: int, D: int, Dp: int, device, with_do: bool = False):
    """the streamed kernels' (B, L, H, Dp) bf16 scratch: the normalised and
    rotated q and k; v, and with ``with_do`` dO, padded copies only where Dp
    != D (else None: the kernels read them where they lie)"""
    def rows():
        return torch.empty(B, L, H, Dp, dtype=torch.bfloat16, device=device)

    return [rows(), rows(), *(rows() if Dp != D else None for _ in range(2 if with_do else 1))]


def _ptrs(tensors) -> list:
    return [None if t is None else t.data_ptr() for t in tensors]


def fused_attention_fwd_cuda(qkv, q_gamma, k_gamma, n_heads, residuals: bool = True):
    """K9 (csrc/fused_attention.cu where ``resident``, else
    csrc/attention_stream.cu): bf16 packed qkv -> (out, lse) as
    ``fused_attention_fwd_plain`` returns them; with ``residuals`` False the
    kernel writes out alone and lse is None (no gradient will be taken)"""
    B, L, H, D = _check_kernel_shapes(qkv, n_heads)
    dev = qkv.device
    cos, sin, gq, gk = _kernel_inputs(qkv, q_gamma, k_gamma, L, D)
    out = torch.empty(B, L, H * D, dtype=torch.bfloat16, device=dev)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=dev) if residuals else None
    lse_ptr = None if lse is None else lse.data_ptr()
    if resident(L, D):
        run(
            "odt_fused_attention_fwd", "fused_attention_fwd", dev,
            *(t.data_ptr() for t in (qkv, gq, gk, cos, sin, out)), lse_ptr, B, L, H, D, D**-0.5,
        )
        return out, lse
    Dp = stream_dim(D)
    rows = _stream_rows(B, L, H, D, Dp, dev)
    run(
        "odt_fused_attention_stream_fwd", "fused_attention_fwd", dev,
        *_ptrs((qkv, gq, gk, cos, sin, *rows, out)), lse_ptr, B, L, H, D, Dp, D**-0.5,
    )
    return out, lse


def fused_attention_bwd_cuda(qkv, grad, out, lse, q_gamma, k_gamma, n_heads):
    """K10 (csrc/fused_attention.cu where ``resident``, else
    csrc/attention_stream.cu): -> (dqkv bf16, dq_gamma f32, dk_gamma f32);
    the gamma partials (one per (batch, head) at D 32 and 64, per 64-row
    tile too at 128, per POST_CHUNK rows when streamed, q's and k's
    in one array) are summed here"""
    B, L, H, D = _check_kernel_shapes(qkv, n_heads)
    dev = qkv.device
    grad = grad.to(torch.bfloat16).contiguous()
    for name, t, dtype, shape in (("grad", grad, torch.bfloat16, (B, L, H * D)),
                                  ("out", out, torch.bfloat16, (B, L, H * D)),
                                  ("lse", lse, torch.float32, (B, H, L))):
        check_cuda(name, t, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    cos, sin, gq, gk = _kernel_inputs(qkv, q_gamma, k_gamma, L, D)
    dqkv = torch.empty_like(qkv)
    if resident(L, D):
        parts = -(-L // 64) if D == 128 else 1
        dgq, dgk = (torch.empty(parts * B * H, D, dtype=torch.float32, device=dev)
                    for _ in range(2))
        run(
            "odt_fused_attention_bwd", "fused_attention_bwd", dev,
            *(t.data_ptr() for t in (qkv, grad, out, lse, gq, gk, cos, sin, dqkv, dgq, dgk)),
            B, L, H, D, D**-0.5,
        )
        return dqkv, dgq.sum(0), dgk.sum(0)
    Dp = stream_dim(D)
    rows = _stream_rows(B, L, H, D, Dp, dev, with_do=True)
    delta = torch.empty(B, H, L, dtype=torch.float32, device=dev)
    grads = [torch.empty(B, L, H, Dp, dtype=torch.float32, device=dev) for _ in range(2)]
    dg = torch.empty(-(-B * L // POST_CHUNK), 2, D, dtype=torch.float32, device=dev)
    run(
        "odt_fused_attention_stream_bwd", "fused_attention_bwd", dev,
        *_ptrs((qkv, grad, out, lse, gq, gk, cos, sin, *rows, delta, *grads, dqkv, dg)),
        B, L, H, D, Dp, D**-0.5,
    )
    dq_gamma, dk_gamma = dg.sum(0)
    return dqkv, dq_gamma, dk_gamma


def needs_grad(*tensors: torch.Tensor) -> bool:
    """whether autograd will differentiate through an op on ``tensors``"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FusedNormRopeAttention(torch.autograd.Function):
    """K9 forward, K10 backward; the forward's output and lse feed the
    backward"""

    @staticmethod
    def forward(ctx, qkv, q_gamma, k_gamma, n_heads):
        out, lse = fused_attention_fwd_cuda(qkv, q_gamma, k_gamma, n_heads)
        ctx.save_for_backward(qkv, q_gamma, k_gamma, out, lse)
        ctx.n_heads = n_heads
        return out

    @staticmethod
    def backward(ctx, grad):
        qkv, q_gamma, k_gamma, out, lse = ctx.saved_tensors
        dqkv, dgq, dgk = fused_attention_bwd_cuda(qkv, grad, out, lse, q_gamma, k_gamma,
                                                  ctx.n_heads)
        return dqkv.to(qkv.dtype), dgq.to(q_gamma.dtype), dgk.to(k_gamma.dtype), None


def fused_norm_rope_attention(qkv: torch.Tensor, q_gamma: torch.Tensor, k_gamma: torch.Tensor,
                              n_heads: int) -> torch.Tensor:
    """packed (B, L, 3*H*D) -> (B, L, H*D): kernels for CUDA tensors, the
    plain version (autograd) for CPU tensors. As the JAX ``_fwd_impl``
    saves residuals only under its VJP, the forward kernel writes lse only
    when a gradient will be taken (grad mode on and an input requiring
    grad); under ``no_grad`` or ``inference_mode`` it writes out alone"""
    if qkv.is_cuda:
        if needs_grad(qkv, q_gamma, k_gamma):
            return FusedNormRopeAttention.apply(qkv, q_gamma, k_gamma, n_heads)
        return fused_attention_fwd_cuda(qkv, q_gamma, k_gamma, n_heads, residuals=False)[0]
    if qkv.device.type != "cpu":
        raise ValueError(f"fused_norm_rope_attention: no implementation for device {qkv.device}")
    return rope_attention_plain(qkv, q_gamma, k_gamma, n_heads)
