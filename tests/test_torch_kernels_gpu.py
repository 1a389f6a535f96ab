"""Each CUDA kernel of the port against its plain PyTorch version on an
NVIDIA card (skipped where torch.cuda.is_available() is false). Run on the
card with ``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``; this
file imports nothing of JAX.

Small ragged shapes; bf16 kernels are held to 4 ulp of the output's largest
magnitude (they round where the plain versions round, but accumulate their
products in another order, so an intermediate bf16 rounding can flip and pass
through the next projection); the f32 resonator to 1e-5 absolute. The
SwiGLU and film-layer forwards (K4, K2) keep v, g and h in f32 and apply
1/rms(h) after the output product, so they are held to the plain version in
f32 instead: their error's mean within 1.1x and max within 1.5x of the plain
bf16 path's, as chip_smoke.py holds them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.nn.norm import rms_norm
from osu_dreamer_tpu_torch.ops import (
    _build, film_layer, film_qkv, fused_attention, long_attention, norm_rope, resonator, swiglu,
)

BF16_ULPS = 4
MEAN_RATIO, MAX_RATIO = 1.1, 1.5
# training kernels: max abs error against autograd of the plain version in
# f32 on the same inputs, relative to the largest f32 magnitude (the
# kernels differentiate the bf16 forward; chip_smoke.py states the same)
GRAD_REL = 0.03


def _case(kernel: str, dev: str):
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    C, H = 64, 40
    w = [rnd(5, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]
    x = rnd(2, 45, C)
    if kernel == "swiglu":
        return swiglu.swiglu_cuda, swiglu.swiglu_plain, (x, *w)
    if kernel == "film_layer":
        film = [rnd(2, C, scale=0.3) for _ in range(3)] + [1 + rnd(C, scale=0.1)] * 2
        return film_layer.film_layer_cuda, film_layer.film_layer_plain, (x, *film, *w)
    if kernel == "flash_attention":
        qkv = tuple(rnd(2, 77, 3, 64) for _ in range(3))
        return long_attention.attention_cuda, long_attention.attention_plain, qkv
    frames = rnd(2, 150, 98, scale=0.3, dtype=torch.float32)
    return resonator.resonate_cuda, resonator.resonate_plain, (frames,)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["swiglu", "film_layer", "flash_attention", "resonator"])
def test_kernel_matches_plain_on_gpu(kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    cuda_fn, plain_fn, args = _case(kernel, "cuda")
    got, want = cuda_fn(*args).float(), plain_fn(*args).float()
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if kernel in ("swiglu", "film_layer"):
        _f32_rule(got, want, plain_fn(*(t.float() for t in args)).float())
        return
    tol = 1e-5 if kernel == "resonator" else BF16_ULPS * 2.0 ** (
        np.floor(np.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


def _f32_rule(got, plain_bf16, ref) -> None:
    ek, ep = (got - ref).abs(), (plain_bf16 - ref).abs()
    assert ek.mean() <= MEAN_RATIO * ep.mean(), (ek.mean().item(), ep.mean().item())
    assert ek.max() <= MAX_RATIO * ep.max(), (ek.max().item(), ep.max().item())


def _ffn_case(B, L, C, H, seed, film: bool):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    w = [rnd(5, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]
    x = rnd(B, L, C)
    if not film:
        return swiglu.swiglu_cuda, swiglu.swiglu_plain, [x, *w]
    vecs = [rnd(B, C, scale=0.3) for _ in range(3)] + [1 + rnd(C, scale=0.1) for _ in range(2)]
    return film_layer.film_layer_cuda, film_layer.film_layer_plain, [x, *vecs, *w]


# the models' widths, and narrow ones off the 64-column box (C % 16)
FFN_WIDTHS = [(16, 42), (32, 85), (96, 256), (128, 341), (512, 1365), (1024, 2730)]


@pytest.mark.gpu
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("C,H", FFN_WIDTHS)
@pytest.mark.parametrize("B,L", [(1, 1), (2, 65), (3, 77), (1, 300)])
def test_ffn_core_matches_plain_on_gpu(B, L, C, H, film):
    """K4 and K2 (csrc/ffn_core.cuh) at L 1, one row past a 64-row tile, a
    ragged L, B 1, at every width of the models' rule (C 1024: one consumer
    warpgroup) and at widths whose last box runs past C: the f32 rule, and a
    second launch bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    kernel, plain, args = _ffn_case(B, L, C, H, 7, film)
    got = kernel(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _f32_rule(got.float(), plain(*args).float(), plain(*(t.float() for t in args)).float())
    assert torch.equal(kernel(*args), got)


@pytest.mark.gpu
@pytest.mark.parametrize("film", [False, True])
def test_ffn_core_keeps_batch_rows_apart_on_gpu(film):
    """a NaN-filled batch row leaves its neighbours untouched: the tiles run
    over the flattened rows, and the conv selects (not multiplies) zero for
    taps across a batch row"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    kernel, plain, args = _ffn_case(3, 40, 128, 341, 8, film)
    clean = kernel(*args)
    args[0][1] = float("nan")
    dirty = kernel(*args)
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[2], clean[2])


@pytest.mark.gpu
def test_wide_attention_inference_takes_the_flash_kernel_on_gpu(monkeypatch):
    """16 x 64 heads at L 300: past the JAX gate (L H D > 262,144), so
    inference runs the norm and RoPE pass and K7, within the f32 rule of
    the plain path"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from osu_dreamer_tpu_torch.nn import attention as attn_mod

    gen = torch.Generator(device="cuda").manual_seed(9)
    attn = attn_mod.RoPEAttention(512, 16, 64, 512, torch.bfloat16).cuda()
    with torch.no_grad():
        for prm in attn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen, device="cuda") * prm.shape[0] ** -0.5
                      if prm.dim() == 2 else 1 + 0.1 * torch.randn(prm.shape, generator=gen,
                                                                   device="cuda"))
    ref_attn = attn_mod.RoPEAttention(512, 16, 64, 512, torch.float32).cuda()
    ref_attn.load_state_dict(attn.state_dict())
    x = torch.randn(2, 300, 512, generator=gen, device="cuda").to(torch.bfloat16)
    before = dict(_build.launches)
    with torch.inference_mode():
        got = attn(x).float()
        # the f32 reference through the plain attention (the kernels are bf16)
        monkeypatch.setattr(attn_mod, "long_flash_attention", long_attention.attention_plain)
        monkeypatch.setattr(attn_mod, "norm_rope_qkv", norm_rope.norm_rope_qkv_plain)
        ref = ref_attn(x.float()).float()
    assert _build.launches["flash_attention"] == before["flash_attention"] + 1
    assert _build.launches["qk_prep"] == before["qk_prep"] + 1
    assert _build.launches["fused_attention_fwd"] == before["fused_attention_fwd"]
    with torch.inference_mode():  # the plain path of the same layer, bf16
        q, k, v = attn.qkv(x).split(1024, dim=-1)
        B, L = x.shape[:2]
        qr = fused_attention.rope(rms_norm(q.reshape(B, L, 16, 64), attn.q_gamma))
        kr = fused_attention.rope(rms_norm(k.reshape(B, L, 16, 64), attn.k_gamma))
        want = attn.out(long_attention.attention_plain(qr, kr, v.reshape(B, L, 16, 64))).float()
    _f32_rule(got, want, ref)


@pytest.mark.gpu
def test_widened_backward_kernels_on_gpu():
    """the widths where the JAX package runs Pallas and the port's kernels
    were widened: K6 at C 640 (48-row blocks), K11/K12 at C 640 F 3072 and C
    1024 F 1920 (K12 in clusters of three and four CTAs)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(10)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    C, H = 640, 1706
    x, go = rnd(3, 101, C).to(torch.bfloat16), rnd(3, 101, C).to(torch.bfloat16)
    w = [rnd(5, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5)]
    assert swiglu.bwd_route(C, H, 5) == "partial"
    _grads_close(swiglu.swiglu_bwd_cuda(x, *w, go), swiglu.swiglu_bwd_plain(x.float(), *w, go.float()))
    for B, L, C, F in ((2, 77, 640, 3072), (2, 70, 1024, 1920)):
        args, g = _prologue_case(B, L, C, F, 11)
        got, want = film_qkv.film_qkv_fwd_cuda(*args).float(), film_qkv.film_qkv_plain(*args).float()
        tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        assert (got - want).abs().max().item() <= tol
        grads = film_qkv.film_qkv_bwd_cuda(*args, g)
        _grads_close(grads, film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), g.float()))
        assert all(torch.equal(a, b) for a, b in zip(grads, film_qkv.film_qkv_bwd_cuda(*args, g)))


def _ulp_tol(want: torch.Tensor) -> float:
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)


def _attention_qkv(B: int, L: int, H: int, seed: int) -> list[torch.Tensor]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, L, H, 64, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H", [(1, 1, 1), (2, 63, 3), (1, 64, 16), (3, 65, 2), (1, 193, 2),
                                   (4, 759, 16), (1, 2500, 16)])
def test_flash_attention_matches_plain_on_gpu(B, L, H):
    """K7/K8 (4 ulp of the plain version) at the kernel's tile edges (64-key
    tiles, 192 queries a block), the sampler's B4 L759 and K8's range; a
    second launch is bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    q, k, v = _attention_qkv(B, L, H, 7)
    got = long_attention.attention_cuda(q, k, v)
    want = long_attention.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert got.shape == (B, L, H * 64) and bool(torch.isfinite(got).all())
    assert (got.float() - want).abs().max().item() <= _ulp_tol(want)
    assert torch.equal(got, long_attention.attention_cuda(q, k, v))


@pytest.mark.gpu
def test_flash_attention_keeps_batch_rows_apart_on_gpu():
    """batch row 1 holds values 1e4 times larger: each row equals the plain
    version run on that row alone (no key, value or query crosses rows)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    q, k, v = _attention_qkv(3, 77, 2, 8)
    for t in (q, k, v):
        t[1] *= 1e4
    got = long_attention.attention_cuda(q, k, v).float()
    for b in range(3):
        want = long_attention.attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1]).float()
        assert (got[b:b + 1] - want).abs().max().item() <= _ulp_tol(want), f"batch row {b}"


@pytest.mark.gpu
def test_flash_attention_ignores_the_buffer_past_its_batch_on_gpu():
    """q, k, v are the first B rows of (B+1, L, H, 64) buffers whose last
    row is NaN, at a ragged L: the zero fill of the last key tile never reads
    that row, so the output is finite and equals the plain version"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    B, L, H = 2, 77, 3
    bufs = _attention_qkv(B + 1, L, H, 9)
    for t in bufs:
        t[B] = float("nan")
    q, k, v = (t[:B] for t in bufs)
    assert q.is_contiguous()
    got = long_attention.attention_cuda(q, k, v).float()
    want = long_attention.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= _ulp_tol(want)


def _grads_close(got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        assert err <= GRAD_REL * scale, f"gradient {i}: max abs err {err:.4g}, max |f32| {scale:.4g}"


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H", [(2, 77, 2), (1, 20, 4), (2, 256, 2), (2, 152, 2), (1, 1, 1),
                                   (1, 63, 1), (1, 64, 1), (1, 65, 1), (1, 192, 1), (1, 193, 1),
                                   (1, 256, 1), (2, 256, 8)])
def test_fused_attention_kernels_match_plain_on_gpu(B, L, H):
    """K9 forward (4 ulp) and K10 gradients (GRAD_REL) at ragged lengths (the
    edges of one to four 64-row tiles) and the longest the kernels take;
    both rerun bit-identically"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = (torch.randn(B, L, 3 * H * 64, generator=gen, device="cuda") * 0.7).to(torch.bfloat16)
    qg, kg = (1 + 0.2 * torch.randn(64, generator=gen, device="cuda") for _ in range(2))
    res = fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, H)
    want, want_lse = fused_attention.fused_attention_fwd_plain(qkv, qg, kg, H)
    torch.cuda.synchronize()
    want = want.float()
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert (res[0].float() - want).abs().max().item() <= tol
    assert (res[1] - want_lse).abs().max().item() <= 2e-3
    assert all(torch.equal(a, b) for a, b in
               zip(res, fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, H)))
    grad = torch.randn(B, L, H * 64, generator=gen, device="cuda").to(torch.bfloat16)
    got = fused_attention.fused_attention_bwd_cuda(qkv, grad, *res, qg, kg, H)
    _grads_close(got, fused_attention.fused_attention_bwd_plain(qkv.float(), grad.float(), *res,
                                                                qg, kg, H))
    again = fused_attention.fused_attention_bwd_cuda(qkv, grad, *res, qg, kg, H)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_fused_attention_forward_without_residuals_on_gpu():
    """where no gradient will be taken the forward kernel writes out alone,
    and that out is the training forward's, bit for bit"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = (torch.randn(3, 152, 3 * 4 * 64, generator=gen, device="cuda") * 0.7).to(torch.bfloat16)
    qg, kg = (1 + 0.2 * torch.randn(64, generator=gen, device="cuda") for _ in range(2))
    out, lse = fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, 4, residuals=False)
    assert lse is None
    assert torch.equal(out, fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, 4)[0])
    leaves = [t.clone().requires_grad_() for t in (qkv, qg, kg)]
    before = _build.launches["fused_attention_fwd"]
    with torch.no_grad():
        inference = fused_attention.fused_norm_rope_attention(*leaves, 4)
    training = fused_attention.fused_norm_rope_attention(*leaves, 4)
    assert _build.launches["fused_attention_fwd"] == before + 2
    assert training.requires_grad and not inference.requires_grad
    assert torch.equal(inference, out) and torch.equal(training.detach(), out)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C,H,K", [(2, 45, 64, 40, 5), (1, 70, 32, 20, 3)])
def test_swiglu_bwd_kernel_matches_plain_on_gpu(B, L, C, H, K):
    """K6: dx and the six weight gradients (GRAD_REL), ragged L, odd H"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x, go = rnd(B, L, C).to(torch.bfloat16), rnd(B, L, C).to(torch.bfloat16)
    w = [rnd(K, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5)]
    _grads_close(swiglu.swiglu_bwd_cuda(x, *w, go),
                 swiglu.swiglu_bwd_plain(x.float(), *w, go.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C,H,K,zero_film", [(2, 77, 128, 341, 5, False),
                                                 (3, 38, 128, 341, 5, True),
                                                 (1, 70, 32, 20, 3, False),
                                                 (2, 77, 256, 682, 5, False),
                                                 (2, 41, 384, 1024, 5, False)])
def test_film_layer_bwd_kernel_matches_plain_on_gpu(B, L, C, H, K, zero_film):
    """K3: dx and the eleven parameter / FiLM gradients (GRAD_REL) at a
    ragged L (flat 64-row tiles straddling batch rows, the hidden split of
    short inputs), H padded to a multiple of 64, zero and nonzero FiLM; a
    second launch is bit-identical (fixed-order sums, no float atomics); and
    ``film_layer`` on CUDA tensors builds its graph through K2 and K3"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x, go = rnd(B, L, C).to(torch.bfloat16), rnd(B, L, C).to(torch.bfloat16)
    film = [torch.zeros(B, C, device="cuda") if zero_film else rnd(B, C, scale=0.3)
            for _ in range(3)]
    # f32 parameters, as in training, holding bf16 values: the kernel rounds
    # them to bf16, so the f32 reference then sees the same weights
    params = [1 + rnd(C, scale=0.1), 1 + rnd(C, scale=0.1), rnd(K, C, scale=0.4),
              rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5), rnd(2 * H, scale=0.1),
              rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]
    args = [x, *(t.to(torch.bfloat16) for t in film),
            *(t.to(torch.bfloat16).float() for t in params)]
    got = film_layer.film_layer_bwd_cuda(*args, go)
    want = film_layer.film_layer_bwd_plain(*(t.float() for t in args), go.float())
    _grads_close(got, want)
    again = film_layer.film_layer_bwd_cuda(*args, go)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    leaves = [t.detach().clone().requires_grad_() for t in args]
    before = _build.launches["film_layer_bwd"]
    out = film_layer.film_layer(*leaves)
    assert type(out.grad_fn).__name__ == "FilmLayerFunctionBackward"
    grads = torch.autograd.grad(out, leaves, go)
    assert _build.launches["film_layer_bwd"] == before + 1
    for g, k in zip(grads, got):  # each cast to its input's dtype
        assert torch.equal(g, k.to(g.dtype))


def _prologue_case(B, L, C, F, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    # f32 parameters, as in training, holding bf16 values
    return [rnd(B, L, C), rnd(B, C, scale=0.3), rnd(B, C, scale=0.3), rnd(B, L, C, scale=0.5),
            rnd(C, F, scale=C**-0.5).float(), rnd(F, scale=0.1).float()], rnd(B, L, F)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C,F", [(2, 77, 128, 384), (3, 64, 512, 3072), (1, 150, 384, 1152)])
def test_film_qkv_kernels_match_plain_on_gpu(B, L, C, F):
    """K11 (4 ulp of the plain version) and K12 (GRAD_REL of f32 autograd of
    the plain version; a second launch bit-identical) at a ragged L, one
    block per sequence and several; ``film_qkv`` on CUDA tensors builds its
    graph through both kernels"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _prologue_case(B, L, C, F, 4)
    got, want = film_qkv.film_qkv_fwd_cuda(*args).float(), film_qkv.film_qkv_plain(*args).float()
    torch.cuda.synchronize()
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert bool(torch.isfinite(got).all()) and (got - want).abs().max().item() <= tol
    grads = film_qkv.film_qkv_bwd_cuda(*args, go)
    _grads_close(grads, film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), go.float()))
    again = film_qkv.film_qkv_bwd_cuda(*args, go)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))

    leaves = [t.detach().clone().requires_grad_() for t in args]
    before = dict(_build.launches)
    out = film_qkv.film_qkv(*leaves)
    assert type(out.grad_fn).__name__ == "FilmQKVFunctionBackward"
    torch.autograd.grad(out, leaves, go)
    assert _build.launches["film_qkv_fwd"] == before["film_qkv_fwd"] + 1
    assert _build.launches["film_qkv_bwd"] == before["film_qkv_bwd"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C,H,K", [(2, 45, 64, 40, 5), (2, 70, 128, 341, 5), (1, 33, 384, 1024, 3)])
def test_swiglu_bwd_full_kernel_matches_plain_on_gpu(B, L, C, H, K):
    """K5: dx and the six weight gradients (GRAD_REL), ragged L, H padded to
    16; a second launch is bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x, go = rnd(B, L, C).to(torch.bfloat16), rnd(B, L, C).to(torch.bfloat16)
    w = [rnd(K, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5)]
    got = swiglu.swiglu_bwd_full_cuda(x, *w, go)
    _grads_close(got, swiglu.swiglu_bwd_plain(x.float(), *w, go.float()))
    again = swiglu.swiglu_bwd_full_cuda(x, *w, go)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,kernel", [(384, 1024, "swiglu_bwd_full"), (512, 1365, "swiglu_bwd")])
def test_swiglu_function_launches_the_jax_backward_on_gpu(C, H, kernel):
    """``swiglu`` on CUDA tensors takes K5 where the JAX dispatch takes its
    full backward and K6 elsewhere (the launch counters)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 40, C, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
    w = [torch.randn(*shape, generator=gen, device="cuda").mul_(0.05).requires_grad_()
         for shape in ((5, C), (C,), (C, 2 * H), (2 * H,), (H, C), (C,))]
    before = dict(_build.launches)
    torch.autograd.grad(swiglu.swiglu(x, *w).float().square().sum(), [x, *w])
    other = "swiglu_bwd" if kernel == "swiglu_bwd_full" else "swiglu_bwd_full"
    assert _build.launches[kernel] == before[kernel] + 1
    assert _build.launches[other] == before[other]


def _film_bwd_case(B, L, C, H, seed, zero_film=False):
    """K3's inputs: bf16 x, FiLM vectors and output gradient, f32 parameters
    holding bf16 values (as in training)"""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x, go = rnd(B, L, C).to(torch.bfloat16), rnd(B, L, C).to(torch.bfloat16)
    film = [torch.zeros(B, C, device="cuda") if zero_film else rnd(B, C, scale=0.3)
            for _ in range(3)]
    params = [1 + rnd(C, scale=0.1), 1 + rnd(C, scale=0.1), rnd(5, C, scale=0.4),
              rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5), rnd(2 * H, scale=0.1),
              rnd(H, C, scale=H**-0.5), rnd(C, scale=0.1)]
    return [x, *(t.to(torch.bfloat16) for t in film),
            *(t.to(torch.bfloat16).float() for t in params)], go


@pytest.mark.gpu
@pytest.mark.parametrize("C,H", [(32, 85), (64, 170), (128, 341), (256, 682), (384, 1024)])
@pytest.mark.parametrize("B,L", [(3, 1), (64, 38), (2, 65), (4, 1026)])
def test_film_layer_bwd_core_widths_on_gpu(B, L, C, H):
    """K3 on the backward core at every width it takes and at L 1, 38 (the
    hidden split), 65 (a tile past one) and 1026: GRAD_REL of f32 autograd
    of the plain version, and a second launch bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _film_bwd_case(B, L, C, H, 20)
    got = film_layer.film_layer_bwd_cuda(*args, go)
    _grads_close(got, film_layer.film_layer_bwd_plain(*(t.float() for t in args), go.float()))
    assert all(torch.equal(a, b) for a, b in zip(got, film_layer.film_layer_bwd_cuda(*args, go)))


@pytest.mark.gpu
@pytest.mark.parametrize("zero_film", [False, True])
@pytest.mark.parametrize("L", [1026, 342, 114, 38])
def test_film_layer_bwd_latent_levels_on_gpu(L, zero_film):
    """K3 at latent training's four levels (B 64, C 128), with and without
    FiLM: GRAD_REL, and one launch counted a call"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _film_bwd_case(64, L, 128, 341, 21, zero_film)
    before = _build.launches["film_layer_bwd"]
    got = film_layer.film_layer_bwd_cuda(*args, go)
    assert _build.launches["film_layer_bwd"] == before + 1
    _grads_close(got, film_layer.film_layer_bwd_plain(*(t.float() for t in args), go.float()))


@pytest.mark.gpu
def test_backward_core_keeps_batch_rows_apart_on_gpu():
    """a NaN-filled batch row leaves the other rows' dx untouched in K3 and
    K6: the tiles run over the flattened rows, the conv and its transpose
    select zero across a batch row"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _film_bwd_case(3, 40, 128, 341, 22)
    clean = film_layer.film_layer_bwd_cuda(*args, go)[0]
    args[0][1] = float("nan")
    dirty = film_layer.film_layer_bwd_cuda(*args, go)[0]
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[2], clean[2])
    x, w, g = _swiglu_bwd_case(3, 40, 512, 1365, 23)
    clean = swiglu.swiglu_bwd_cuda(x, *w, g)[0]
    x[1] = float("nan")
    dirty = swiglu.swiglu_bwd_cuda(x, *w, g)[0]
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[2], clean[2])


def _swiglu_bwd_case(B, L, C, H, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x, go = rnd(B, L, C).to(torch.bfloat16), rnd(B, L, C).to(torch.bfloat16)
    w = [rnd(5, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5)]
    return x, [t.to(torch.bfloat16).float() for t in w], go


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,kernel", [(512, 1365, "swiglu_bwd"), (640, 1706, "swiglu_bwd"),
                                        (448, 1194, "swiglu_bwd"),
                                        (384, 1024, "swiglu_bwd_full"),
                                        (480, 1280, "swiglu_bwd_full"),
                                        (128, 341, "swiglu_bwd_full")])
@pytest.mark.parametrize("B,L", [(3, 1), (8, 38), (2, 65), (1, 1026)])
def test_swiglu_bwd_core_widths_on_gpu(B, L, C, H, kernel):
    """K6 and K5 on the backward core at their widths and at L 1, 38, 65 and
    1026 (C 448: an odd count of dY tiles split between pass B's paired
    warpgroups; C 480: a half-filled last tile; C 384 and 640: column
    groups): GRAD_REL of f32 autograd
    of the plain version, a second launch bit-identical, one launch counted
    a call"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    x, w, go = _swiglu_bwd_case(B, L, C, H, 24)
    fn = getattr(swiglu, f"{kernel}_cuda")
    before = _build.launches[kernel]
    got = fn(x, *w, go)
    assert _build.launches[kernel] == before + 1
    _grads_close(got, swiglu.swiglu_bwd_plain(x.float(), *w, go.float()))
    assert all(torch.equal(a, b) for a, b in zip(got, fn(x, *w, go)))


@pytest.mark.gpu
@pytest.mark.parametrize("S,K", [(1, 1), (3, 63), (3, 64), (3, 65), (3, 127), (3, 129),
                                 (2, 2200), (1, 4500), (1, 20481)])
def test_resonator_ragged_shapes_on_gpu(S, K):
    """K1 at one frame, ragged and exact 128-frame chunks, group aggregates in
    use (2200, 4500 frames) and a 2-minute song plus one frame:
    within 1e-5 of the plain version, and a second launch bit-identical (the
    carries combine in a fixed order)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(K)
    frames = torch.randn(S, K, 98, generator=gen, device="cuda") * 0.3
    got = resonator.resonate_cuda(frames)
    want = resonator.resonate_plain(frames)
    torch.cuda.synchronize()
    assert got.shape == (S, K, 72, 2) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(resonator.resonate_cuda(frames), got)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [384, 512, 640, 1024])
@pytest.mark.parametrize("L", [1, 63, 64, 65])
def test_film_qkv_fwd_widths_and_edges_on_gpu(C, L):
    """K11 at every width class (two consumer warpgroups to C 512, one
    past it) and the edges of a 64-row tile, three batch rows so that rows
    of several meet in one tile: 4 ulp of the plain version, a second launch
    bit-identical, and the y it multiplies equal bit for bit to the y K12's
    row pass recomputes"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    B, F = 3, 3 * 4 * 64
    args, go = _prologue_case(B, L, C, F, C + L)
    y11 = torch.empty(B * L, C, dtype=torch.bfloat16, device="cuda")
    y12 = torch.empty_like(y11)
    got = film_qkv.film_qkv_fwd_cuda(*args, y_out=y11)
    want = film_qkv.film_qkv_plain(*args).float()
    film_qkv.film_qkv_bwd_cuda(*args, go, y_out=y12)
    torch.cuda.synchronize()
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert bool(torch.isfinite(got).all()) and (got.float() - want).abs().max().item() <= tol
    assert torch.equal(film_qkv.film_qkv_fwd_cuda(*args), got)
    assert torch.equal(y11, y12)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [384, 512, 640, 1024])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 129])
def test_film_qkv_bwd_widths_and_edges_on_gpu(C, L):
    """K12 at every cluster width (two CTAs a tile at C 384 and 512, three
    at 640, four at 1024) and the edges of a 64- and a 128-row tile, three
    batch rows so that tiles straddle them (at L 1 one tile holds all
    three): the six gradients within GRAD_REL of f32 autograd of the plain
    version, a second launch bit-identical, and the y its y pass recomputes
    equal bit for bit to the y K11 multiplies"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    B, F = 3, 3 * 4 * 64
    args, go = _prologue_case(B, L, C, F, 2 * C + L)
    y11 = torch.empty(B * L, C, dtype=torch.bfloat16, device="cuda")
    y12 = torch.empty_like(y11)
    film_qkv.film_qkv_fwd_cuda(*args, y_out=y11)
    grads = film_qkv.film_qkv_bwd_cuda(*args, go, y_out=y12)
    torch.cuda.synchronize()
    _grads_close(grads, film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), go.float()))
    assert all(torch.equal(a, b) for a, b in zip(grads, film_qkv.film_qkv_bwd_cuda(*args, go)))
    assert torch.equal(y11, y12)


@pytest.mark.gpu
def test_film_qkv_bwd_persistent_clusters_on_gpu():
    """more 128-row tiles than clusters the card holds at once (B64 L152
    C512: 76 tiles, at most 66 two-CTA clusters at once), so some take two
    and the exchange buffers alternate: GRAD_REL, bit-identical rerun"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _prologue_case(64, 152, 512, 3072, 9)
    grads = film_qkv.film_qkv_bwd_cuda(*args, go)
    _grads_close(grads, film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), go.float()))
    assert all(torch.equal(a, b) for a, b in zip(grads, film_qkv.film_qkv_bwd_cuda(*args, go)))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("B,L", [(1, 1), (2, 63), (3, 65), (1, 193), (4, 759), (1, 2500)])
def test_flash_attention_matches_plain_on_gpu_at_head_dims(B, L, D):
    """K7/K8 at head dims 32 (one zero-padded box a head) and 128 (two):
    4 ulp of the plain version, a second launch bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(L + D)
    H = 1024 // D
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = long_attention.attention_cuda(q, k, v)
    want = long_attention.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert got.shape == (B, L, H * D) and bool(torch.isfinite(got).all())
    assert (got.float() - want).abs().max().item() <= _ulp_tol(want)
    assert torch.equal(got, long_attention.attention_cuda(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("D,H", [(32, 4), (128, 1), (128, 8)])
@pytest.mark.parametrize("B,L", [(2, 77), (1, 1), (1, 64), (1, 65), (2, 152), (1, 193),
                                 (1, 256)])
def test_fused_attention_kernels_match_plain_on_gpu_at_head_dims(B, L, D, H):
    """K9 (4 ulp) and K10 (GRAD_REL; at head dim 128 its two launches) at
    head dims 32 and 128 over the tile edges; both rerun bit-identically"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(B * L + D)
    qkv = (torch.randn(B, L, 3 * H * D, generator=gen, device="cuda") * 0.7).to(torch.bfloat16)
    qg, kg = (1 + 0.2 * torch.randn(D, generator=gen, device="cuda") for _ in range(2))
    res = fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, H)
    want, want_lse = fused_attention.fused_attention_fwd_plain(qkv, qg, kg, H)
    torch.cuda.synchronize()
    want = want.float()
    assert (res[0].float() - want).abs().max().item() <= _ulp_tol(want)
    assert (res[1] - want_lse).abs().max().item() <= 2e-3
    grad = torch.randn(B, L, H * D, generator=gen, device="cuda").to(torch.bfloat16)
    got = fused_attention.fused_attention_bwd_cuda(qkv, grad, *res, qg, kg, H)
    _grads_close(got, fused_attention.fused_attention_bwd_plain(qkv.float(), grad.float(), *res,
                                                                qg, kg, H))
    again = fused_attention.fused_attention_bwd_cuda(qkv, grad, *res, qg, kg, H)
    assert all(torch.equal(a, b) for a, b in zip(got, again))



# the streamed kernels (csrc/attention_stream.cu): head dims off the
# templated ones, padded to a multiple of 8 (5, odd, and 12) or read as they
# are, one box a head (5..48), two (72, 96, 128 past L 256), three (136,
# 192), four (200, 256; the last box of 72, 136 and 200 eight columns wide)
# and past four, split over CTAs (264, 384)
STREAM_HEAD_DIMS = (5, 12, 16, 40, 48, 72, 96, 136, 192, 200, 256, 264, 384)


@pytest.mark.gpu
@pytest.mark.parametrize("D", STREAM_HEAD_DIMS)
@pytest.mark.parametrize("B,L", [(1, 1), (2, 65), (1, 127), (2, 128), (1, 129), (1, 191),
                                 (4, 759), (1, 2500)])
def test_flash_attention_matches_plain_on_gpu_at_streamed_head_dims(B, L, D):
    """K7/K8 on the streamed kernel: 4 ulp of the plain version, columns past
    D never written, a second launch bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(L + D)
    H = 2
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got = long_attention.attention_cuda(q, k, v)
    want = long_attention.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert got.shape == (B, L, H * D) and bool(torch.isfinite(got).all())
    assert (got.float() - want).abs().max().item() <= _ulp_tol(want)
    assert torch.equal(got, long_attention.attention_cuda(q, k, v))


# (B, L, H, D) inside the JAX gate that the resident kernels do not hold:
# the denoiser's 8 x 96 at L 320, 8 x 64 past L 256, 2 x 64 at L 2048 (L H D
# = 262,144), 32 x 12 (padded to 16), 64 x 2 (the smallest, padded to 8),
# and the other head dims at their edges; then lengths at the edges of the
# forward's 192-row and 128-row CTAs and the dQ launch's 128-row ones (L
# 127, 128, 129, 191), and head dims whose last box is partial or whose box
# count changes (72, 136, 200; 264 past four boxes)
STREAM_FUSED = [(2, 320, 8, 96), (2, 257, 8, 64), (1, 512, 8, 64), (1, 2048, 2, 64),
                (2, 152, 32, 12), (1, 1, 32, 12), (2, 77, 64, 2), (2, 77, 8, 16), (1, 65, 16, 40),
                (2, 130, 8, 48), (1, 64, 4, 96), (1, 256, 2, 192), (1, 193, 1, 256),
                (1, 300, 2, 384), (1, 257, 2, 128),
                (1, 127, 8, 96), (2, 128, 4, 96), (1, 129, 8, 96), (1, 191, 4, 96),
                (2, 127, 2, 256), (1, 129, 2, 192), (1, 191, 8, 48),
                (1, 320, 4, 72), (2, 200, 2, 136), (1, 150, 2, 200), (1, 130, 2, 264)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,D", STREAM_FUSED)
def test_fused_attention_streamed_kernels_match_plain_on_gpu(B, L, H, D):
    """K9 (4 ulp, lse within 2e-3) and K10 (GRAD_REL) on the streamed
    kernels, the residual-free forward equal to the training one; both
    rerun bit-identically"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    assert not fused_attention.resident(L, D)
    gen = torch.Generator(device="cuda").manual_seed(B * L + D)
    qkv = (torch.randn(B, L, 3 * H * D, generator=gen, device="cuda") * 0.7).to(torch.bfloat16)
    qg, kg = (1 + 0.2 * torch.randn(D, generator=gen, device="cuda") for _ in range(2))
    res = fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, H)
    want, want_lse = fused_attention.fused_attention_fwd_plain(qkv, qg, kg, H)
    torch.cuda.synchronize()
    want = want.float()
    assert (res[0].float() - want).abs().max().item() <= _ulp_tol(want)
    assert (res[1] - want_lse).abs().max().item() <= 2e-3
    bare, no_lse = fused_attention.fused_attention_fwd_cuda(qkv, qg, kg, H, residuals=False)
    assert no_lse is None and torch.equal(bare, res[0])
    grad = torch.randn(B, L, H * D, generator=gen, device="cuda").to(torch.bfloat16)
    got = fused_attention.fused_attention_bwd_cuda(qkv, grad, *res, qg, kg, H)
    _grads_close(got, fused_attention.fused_attention_bwd_plain(qkv.float(), grad.float(), *res,
                                                                qg, kg, H))
    again = fused_attention.fused_attention_bwd_cuda(qkv, grad, *res, qg, kg, H)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---- training past the JAX fused-attention gate: the long attention backward ----


@pytest.mark.gpu
@pytest.mark.parametrize("D", [5, 8, 12, 64, 96, 128, 256, 384])
@pytest.mark.parametrize("B,L", [(1, 1), (2, 65), (1, 300), (1, 2500)])
def test_long_attention_bwd_matches_plain_on_gpu(B, L, D):
    """the streamed forward with lse (4 ulp) and the long attention backward
    (dq, dk, dv within GRAD_REL of the f32 autograd of the plain version;
    at L 1 dq and dk exactly 0), rerunning bit-identically; D 5 and 12 are
    padded to Dp 8 and 16"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(B * L + D)
    H = 2
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    grad = torch.randn(B, L, H * D, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse, rows = long_attention.attention_fwd_cuda(q, k, v)
    want = long_attention.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert (out.float() - want).abs().max().item() <= _ulp_tol(want)
    got = long_attention.attention_bwd_cuda(*rows, out, lse, grad, D)
    assert all(g.shape == (B, L, H, D) and g.dtype == torch.bfloat16 for g in got)
    _grads_close(got, long_attention.attention_bwd_plain(q.float(), k.float(), v.float(),
                                                         grad.float()))
    if L == 1:
        assert not got[0].any() and not got[1].any()
    again = long_attention.attention_bwd_cuda(*rows, out, lse, grad, D)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("H,D", [(16, 8), (32, 12), (16, 64), (8, 96), (8, 128)])
@pytest.mark.parametrize("B,L", [(1, 1), (2, 65), (8, 320), (1, 2500)])
def test_one_pass_long_attention_bwd_on_gpu(B, L, H, D):
    """csrc/long_attention_bwd.cu at phase 1g's heads of head dim up to 128
    (its B8 L320) and at L 1, 65 and 2500: one counted launch; dq, dk and
    dv bf16 views of one packed (B, L, 3 H De) buffer (no f32 array
    returned) within GRAD_REL of the f32 autograd of the plain version (at
    L 1 dq and dk exactly 0); a rerun bit-identical"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    gen = torch.Generator(device="cuda").manual_seed(B * L + H * D)
    q, k, v = (torch.randn(B, L, H, D, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    grad = torch.randn(B, L, H * D, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse, rows = long_attention.attention_fwd_cuda(q, k, v)
    before = _build.launches["long_attention_bwd"]
    got = long_attention.attention_bwd_cuda(*rows, out, lse, grad, D)
    assert _build.launches["long_attention_bwd"] == before + 1
    De = D + D % 2
    base = got[0].untyped_storage()
    for g in got:
        assert g.shape == (B, L, H, D) and g.dtype == torch.bfloat16
        assert g.untyped_storage().data_ptr() == base.data_ptr()
    assert base.nbytes() == B * L * 3 * H * De * 2
    _grads_close(got, long_attention.attention_bwd_plain(q.float(), k.float(), v.float(),
                                                         grad.float()))
    if L == 1:
        assert not got[0].any() and not got[1].any()
    again = long_attention.attention_bwd_cuda(*rows, out, lse, grad, D)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_attention_trains_past_the_gate_through_the_kernels_on_gpu(monkeypatch):
    """16 x 64 heads at L 300 under autograd: one norm and RoPE pass each
    way, one streamed forward (counted as K7) and one long attention
    backward, no plain attention, the q/k/v and gain gradients within
    GRAD_REL of the f32 plain layer's"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from osu_dreamer_tpu_torch.nn import attention as attn_mod

    gen = torch.Generator(device="cuda").manual_seed(11)
    attn = attn_mod.RoPEAttention(512, 16, 64, 512, torch.bfloat16).cuda()
    with torch.no_grad():
        for prm in attn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen, device="cuda") * prm.shape[0] ** -0.5
                      if prm.dim() == 2 else 1 + 0.1 * torch.randn(prm.shape, generator=gen,
                                                                   device="cuda"))
    ref_attn = attn_mod.RoPEAttention(512, 16, 64, 512, torch.float32).cuda()
    ref_attn.load_state_dict(attn.state_dict())
    x = torch.randn(2, 300, 512, generator=gen, device="cuda").to(torch.bfloat16)
    go = torch.randn(2, 300, 512, generator=gen, device="cuda")
    before = dict(_build.launches)
    got = torch.autograd.grad(attn(x), list(attn.parameters()), go.to(torch.bfloat16))
    assert _build.launches["flash_attention"] == before["flash_attention"] + 1
    assert _build.launches["long_attention_bwd"] == before["long_attention_bwd"] + 1
    assert _build.launches["fused_attention_bwd"] == before["fused_attention_bwd"]
    assert _build.launches["qk_prep"] == before["qk_prep"] + 1
    assert _build.launches["qk_post"] == before["qk_post"] + 1
    # the f32 reference through the plain attention (the kernels are bf16)
    monkeypatch.setattr(attn_mod, "long_flash_attention", long_attention.attention_plain)
    monkeypatch.setattr(attn_mod, "norm_rope_qkv", norm_rope.norm_rope_qkv_plain)
    _grads_close(got, torch.autograd.grad(ref_attn(x.float()), list(ref_attn.parameters()), go))


def _tp_slices(w, H: int, tp: int = 2):
    """each rank's (vg_kernel, vg_bias, out_kernel) of H hidden units split
    evenly, and their bounds"""
    from osu_dreamer_tpu_torch.parallel.tp import even_split

    out = []
    for r in range(tp):
        lo, hi = even_split(H, tp, r)
        out.append(((lo, hi), (torch.cat([w[2][:, lo:hi], w[2][:, H + lo:H + hi]], 1),
                               torch.cat([w[3][lo:hi], w[3][H + lo:H + hi]]), w[4][lo:hi])))
    return out


def _tp_swiglu_grads(x, w, go, H: int):
    """the TP forms of two slices run in one process, their partials summed
    as the model group would -> the one-rank gradient tuple"""
    parts = _tp_slices(w, H)
    buf = sum(swiglu.swiglu_tp_partial(x, w[0], w[1], *p, H, 2) for _, p in parts)
    outs = [swiglu.swiglu_tp_bwd(x, w[0], w[1], *p, go, buf, H, 2) for _, p in parts]
    dy = sum(o[0] for o in outs)
    for o in outs:
        o[0].copy_(dy)
    dx, ddw, ddwb, dbout = [o[2]() for o in outs][0]
    dvgk, dvgb, doutk = torch.zeros_like(w[2]), torch.zeros_like(w[3]), torch.zeros_like(w[4])
    for ((lo, hi), _), o in zip(parts, outs):
        a, b, c = o[1]
        n = hi - lo
        dvgk[:, lo:hi], dvgk[:, H + lo:H + hi] = a[:, :n], a[:, n:]
        dvgb[lo:hi], dvgb[H + lo:H + hi] = b[:n], b[n:]
        doutk[lo:hi] = c
    return dx, ddw, ddwb, dvgk, dvgb, doutk, dbout


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C,H,route", [(2, 70, 384, 1024, "full"), (1, 33, 128, 341, "full"),
                                           (2, 45, 512, 1365, "partial"),
                                           (2, 40, 144, 384, "plain")])
def test_swiglu_tp_forms_follow_the_one_rank_route_on_gpu(B, L, C, H, route):
    """two slices' TP forms on the card, routed as the one-rank backward:
    K5's TP form at C 384 and 128 (its dW on csrc/gemm_tn.cuh, counted as
    swiglu_bwd_full_tp), K6's at 512, the plain version at 144; the sums
    through the finish within GRAD_REL of the f32 one-rank plain gradients,
    the kernel forms rerunning bit-identically"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    assert swiglu.swiglu_tp_route(C, 5, H, 2, torch.device("cuda")) == ("kernel", route)
    gen = torch.Generator(device="cuda").manual_seed(C + L)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    x, go = rnd(B, L, C).to(torch.bfloat16), rnd(B, L, C).to(torch.bfloat16)
    w = [rnd(5, C, scale=0.4), rnd(C, scale=0.1), rnd(C, 2 * H, scale=C**-0.5),
         rnd(2 * H, scale=0.1), rnd(H, C, scale=H**-0.5)]
    before = dict(_build.launches)
    got = _tp_swiglu_grads(x, w, go, H)
    counted = {k: _build.launches[k] - before[k] for k in _build.KERNELS}
    kernel = {"full": "swiglu_bwd_full_tp", "partial": "swiglu_bwd_tp", "plain": None}[route]
    assert counted["swiglu_tp"] == 2
    assert {k: n for k, n in counted.items() if n and k != "swiglu_tp"} == (
        {kernel: 2} if kernel else {})
    _grads_close(got, swiglu.swiglu_bwd_plain(x.float(), *w, go.float()))
    if kernel:
        assert all(torch.equal(a, b) for a, b in zip(got, _tp_swiglu_grads(x, w, go, H)))


def _qkv_slices(heads: int, D: int, tp: int):
    """per rank the splits of the packed [q|k|v] kernel's columns and bias"""
    from osu_dreamer_tpu_torch.parallel.tp import Split, even_split

    out = []
    for r in range(tp):
        lo, hi = even_split(heads, tp, r)
        out.append((Split(1, 3, D, heads, lo, hi), Split(0, 3, D, heads, lo, hi)))
    return out


def _tp_prologue(args, go, heads: int, D: int, tp: int):
    """K11's and K12's TP forms on every rank's columns in one process, the
    dy partials summed as the model group would -> (each rank's output,
    the one-rank gradient tuple, each rank's finish)"""
    x, scale, shift, add, kernel, bias = args
    F = kernel.shape[1]
    outs, parts = [], []
    for sk, sb in _qkv_slices(heads, D, tp):
        kr, br = sk.take(kernel), sb.take(bias)
        gr = sk.take(go.reshape(-1, F)).reshape(*go.shape[:2], -1)
        outs.append(film_qkv.film_qkv_tp_fwd_cuda(x, scale, shift, add, kr, br))
        parts.append(film_qkv.film_qkv_tp_bwd_cuda(x, scale, shift, add, kr, br, gr))
    dy = sum(p[0] for p in parts)
    for p in parts:
        p[0].copy_(dy)
    finished = [tuple(t.clone() for t in p[2]()) for p in parts]
    dw, db = torch.zeros_like(kernel), torch.zeros_like(bias)
    for (sk, sb), p in zip(_qkv_slices(heads, D, tp), parts):
        sk.put(dw, p[1][0])
        sb.put(db, p[1][1])
    return outs, (*finished[0], dw, db), finished


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C,heads,D,tp", [(3, 65, 512, 16, 64, 2), (2, 77, 384, 8, 64, 2),
                                               (3, 129, 1024, 8, 128, 4), (4, 1, 640, 4, 64, 2),
                                               (2, 152, 512, 12, 64, 3)])
def test_film_qkv_tp_forms_match_plain_on_gpu(B, L, C, heads, D, tp):
    """K11's TP form on each rank's [q|k|v] columns within 4 ulp of the
    plain version there; K12's TP form on every rank, the dy partials
    summed: the finish equal on every rank bit for bit, the gradients put
    together within GRAD_REL of f32 autograd of the one-rank plain version,
    a rerun bit-identical; one launch of each form a rank counted"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _prologue_case(B, L, C, 3 * heads * D, C + L)
    before = dict(_build.launches)
    outs, got, finished = _tp_prologue(args, go, heads, D, tp)
    counted = {k: _build.launches[k] - before[k] for k in _build.KERNELS}
    assert {k: n for k, n in counted.items() if n} == {"film_qkv_tp": tp, "film_qkv_bwd_tp": tp}
    for (sk, sb), out in zip(_qkv_slices(heads, D, tp), outs):
        want = film_qkv.film_qkv_plain(*args[:4], sk.take(args[4]), sb.take(args[5])).float()
        assert bool(torch.isfinite(out).all())
        assert (out.float() - want).abs().max().item() <= _ulp_tol(want)
    for f in finished[1:]:
        assert all(torch.equal(a, b) for a, b in zip(f, finished[0]))
    _grads_close(got, film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), go.float()))
    again = _tp_prologue(args, go, heads, D, tp)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_film_qkv_tp_function_builds_its_graph_on_gpu():
    """``film_qkv_tp`` on CUDA tensors (a model group of one: the sum is the
    partial itself) builds its graph through the two TP forms and equals
    the one-rank kernels' gradients within GRAD_REL of f32 autograd"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    args, go = _prologue_case(2, 70, 512, 1536, 3)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    before = dict(_build.launches)
    out = film_qkv.film_qkv_tp(*leaves, None)
    assert type(out.grad_fn).__name__ == "FilmQKVTPFunctionBackward"
    grads = torch.autograd.grad(out, leaves, go)
    assert _build.launches["film_qkv_tp"] == before["film_qkv_tp"] + 1
    assert _build.launches["film_qkv_bwd_tp"] == before["film_qkv_bwd_tp"] + 1
    _grads_close(grads, film_qkv.film_qkv_bwd_plain(*(t.float() for t in args), go.float()))


def _unit_tap(w: list[torch.Tensor]) -> list[torch.Tensor]:
    """an FFN's weights with radius 0's unit tap in place of the conv"""
    C = w[2].shape[0]
    return [torch.ones(1, C, device="cuda"), torch.zeros(C, device="cuda"), *w[2:]]


@pytest.mark.gpu
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("C,H", [(128, 341), (384, 1024), (512, 1365)])
def test_unit_tap_runs_the_ffn_kernels_on_gpu(C, H, film):
    """radius 0 (the JAX FFN without its conv) on the FFN kernels with one
    unit tap: K4 / K2 by the f32 rule against the plain version, and the
    backward the one-rank route names (K5 at 128 and 384, K6 at 512; K3
    where it takes the width) within GRAD_REL of f32 autograd, with K = 1"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    kernel, plain, args = _ffn_case(2, 77, C, H, C, film)
    w0 = len(args) - 6
    args = [*args[:w0], *_unit_tap(args[w0:])]
    got = kernel(*args)
    _f32_rule(got.float(), plain(*args).float(), plain(*(t.float() for t in args)).float())
    go = torch.randn(got.shape, device="cuda").to(torch.bfloat16)
    if film:
        if not film_layer.bwd_kernel_fits(C, 1):
            return
        grads = film_layer.film_layer_bwd_cuda(*args, go)
        want = film_layer.film_layer_bwd_plain(*(t.float() for t in args), go.float())
    else:
        route = swiglu.bwd_route(C, H, 1)
        assert route == ("partial" if C == 512 else "full")
        fn = swiglu.swiglu_bwd_cuda if route == "partial" else swiglu.swiglu_bwd_full_cuda
        grads = fn(*args[:6], go)
        want = swiglu.swiglu_bwd_plain(*(t.float() for t in args[:6]), go.float())
    _grads_close(grads, want)
