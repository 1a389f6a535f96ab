"""The long attention route's q/k norm and RoPE (ops/norm_rope.py: the
streamed attention's prep and post passes of csrc/attention_stream.cu).

On the CPU: the entry is the torch chain bit for bit (forward and
gradients) and refuses other devices; the long route hands
``long_flash_attention`` (B, L, H, D) q, k and v once a layer; the two
entries have their launch counters; and the passes' arithmetic, emulated in
torch (the forward's rounding order, the backward's f32 formula), holds to
the plain version. On an NVIDIA card (``-m gpu``): both passes against the
plain version and its autograd, and a CUDA tensor other than bf16 refused.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch
from test_torch_kernels_gpu import GRAD_REL, _grads_close, _ulp_tol

from osu_dreamer_tpu_torch.nn.norm import rms_norm
from osu_dreamer_tpu_torch.ops import _build, long_attention, norm_rope
from osu_dreamer_tpu_torch.ops.fused_attention import attention_route, rope, rope_tables

torch.set_num_threads(1)


def _case(B, L, H, D, dev="cpu", seed=0, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(B, L, 3 * H * D, generator=gen, device=dev) * 0.7).to(dtype)
    qg, kg = (1 + 0.3 * torch.randn(D, generator=gen, device=dev) for _ in range(2))
    return qkv, qg, kg


def _chain(qkv, qg, kg, H):
    """the long route's torch glue as nn/attention.py held it before the
    kernels: split, norm, rotate, v made contiguous"""
    B, L, three_hd = qkv.shape
    D = three_hd // (3 * H)
    q, k, v = qkv.split(H * D, dim=-1)
    q = rope(rms_norm(q.reshape(B, L, H, D), qg))
    k = rope(rms_norm(k.reshape(B, L, H, D), kg))
    return q, k, v.reshape(B, L, H, D).contiguous()


# ---- the CPU entry ----

@pytest.mark.parametrize("B,L,H,D", [(2, 300, 16, 64), (1, 77, 4, 12), (2, 65, 2, 96),
                                     (1, 1, 8, 8)])
def test_cpu_entry_is_the_torch_chain_bit_for_bit(B, L, H, D):
    qkv, qg, kg = _case(B, L, H, D)
    got = norm_rope.norm_rope_qkv(qkv, qg, kg, H)
    want = _chain(qkv, qg, kg, H)
    assert all(g.shape == (B, L, H, D) and g.is_contiguous() for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    grads = [torch.randn(B, L, H, D).to(torch.bfloat16) for _ in range(3)]
    leaves = [t.clone().requires_grad_() for t in (qkv, qg, kg)]
    g_got = torch.autograd.grad(norm_rope.norm_rope_qkv(*leaves, H), leaves, grads)
    g_want = torch.autograd.grad(_chain(*leaves, H), leaves, grads)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))


def test_cpu_entry_refuses_other_devices():
    """neither the passes nor the plain chain for a tensor on neither the
    card nor the CPU"""
    qkv, qg, kg = (t.to("meta") for t in _case(1, 5, 2, 8))
    with pytest.raises(ValueError, match="no implementation for device meta"):
        norm_rope.norm_rope_qkv(qkv, qg, kg, 2)


def test_the_new_kernels_have_launch_counters():
    """their C signatures are held by tests/test_torch_ops.py"""
    for name in ("qk_prep", "qk_post"):
        assert name in _build.KERNELS and name in _build.launches


def _narrow_denoiser(H, D, depth):
    from test_torch_modules import tiny_args

    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel

    args = tiny_args("torch").diffusion
    args = dataclasses.replace(args, backbone_dim=32, backbone=dataclasses.replace(
        args.backbone, n_heads=H, head_dim=D, depth=depth))
    return DiffusionModel(args, torch.float32)


@pytest.mark.parametrize("L,route", [(300, "long"), (64, "fused")])
def test_the_long_route_calls_the_attention_once_a_layer(monkeypatch, L, route):
    """a two-layer denoiser of 16 x 64 heads: past the gate each layer calls
    ``norm_rope_qkv`` once and ``long_flash_attention`` once with (B, L, H,
    D) q, k and v (what the benchmark's K7 span wraps); inside it neither"""
    from osu_dreamer_tpu_torch.nn import attention

    H, D, depth = 16, 64, 2
    assert attention_route(L, H, D) == route
    calls = {"norm_rope_qkv": [], "long_flash_attention": []}

    def record(name, fn):
        def wrapped(*args):
            calls[name].append(tuple(a.shape for a in args if isinstance(a, torch.Tensor)))
            return fn(*args)
        return wrapped

    for name in calls:
        monkeypatch.setattr(attention, name, record(name, getattr(attention, name)))
    model = _narrow_denoiser(H, D, depth)
    gen = torch.Generator().manual_seed(3)
    audio, style, xt = (torch.randn(*s, generator=gen) for s in ((1, L, 16), (1, 8), (1, L, 4)))
    with torch.no_grad():
        model.predict(*model.precompute_cond(audio, style), xt)
    n = depth if route == "long" else 0
    assert len(calls["norm_rope_qkv"]) == len(calls["long_flash_attention"]) == n
    assert all(c == ((1, L, 3 * H * D), (D,), (D,)) for c in calls["norm_rope_qkv"])
    assert all(c == ((1, L, H, D),) * 3 for c in calls["long_flash_attention"])


# ---- the passes' arithmetic, emulated ----

def _prep_emulated(qkv, qg, kg, H):
    """the prep pass's arithmetic in torch: f32 sum of squares, 1 /
    sqrt(mean + 1e-6), then bf16(x inv), bf16(* gamma), the rotary
    products and their sums each rounded to bf16"""
    B, L, three_hd = qkv.shape
    D = three_hd // (3 * H)
    cos, sin = (t.float() for t in rope_tables(L, D, "cpu", torch.bfloat16))
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]

    def bfr(t):
        return t.to(torch.bfloat16).float()

    out = []
    for i, g in ((0, qg), (1, kg)):
        x = qkv[..., i * H * D:(i + 1) * H * D].reshape(B, L, H, D).float()
        inv = 1 / torch.sqrt(x.square().sum(-1, keepdim=True) / D + 1e-6)
        n = bfr(bfr(x * inv) * g.to(torch.bfloat16).float())
        n1, n2 = n.chunk(2, dim=-1)
        out.append(torch.cat([bfr(n1 * cos) - bfr(n2 * sin), bfr(n1 * sin) + bfr(n2 * cos)],
                             -1).to(torch.bfloat16))
    return out


@pytest.mark.parametrize("B,L,H,D", [(2, 300, 16, 64), (1, 77, 4, 12), (2, 65, 2, 96),
                                     (1, 33, 2, 256)])
def test_prep_rounding_order_is_the_plain_one(B, L, H, D):
    """the forward's emulation against the plain bf16 chain: only the sum of
    squares' order differs, so at most one bf16 rounding step apart and
    nearly every element equal"""
    qkv, qg, kg = _case(B, L, H, D, seed=D)
    want = _chain(qkv, qg, kg, H)
    for got, w in zip(_prep_emulated(qkv, qg, kg, H), want[:2]):
        w = w.float()
        err = (got.float() - w).abs()
        assert err.max().item() <= _ulp_tol(w)
        assert (err > 0).float().mean().item() < 0.01


def _post_emulated(qkv, dq, dk, dv, qg, kg, H):
    """the post pass's arithmetic in torch, f32 from the bf16 inputs: the
    inverse rotation, the gamma-scaled RMS norm's derivative with 1/rms
    recomputed, the gains' gradients against x / rms in f32"""
    B, L, three_hd = qkv.shape
    D = three_hd // (3 * H)
    cos, sin = (t.float() for t in rope_tables(L, D, "cpu", torch.bfloat16))
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    parts, dgs = [], []
    for i, g, d in ((0, qg, dq), (1, kg, dk)):
        x = qkv[..., i * H * D:(i + 1) * H * D].reshape(B, L, H, D).float()
        g = g.to(torch.bfloat16).float()
        d1, d2 = d.float().chunk(2, dim=-1)
        gn = torch.cat([d1 * cos + d2 * sin, d2 * cos - d1 * sin], -1)
        inv = 1 / torch.sqrt(x.square().sum(-1, keepdim=True) / D + 1e-6)
        m = (gn * g * x).sum(-1, keepdim=True) / D
        parts.append((gn * g * inv - x * inv**3 * m).reshape(B, L, H * D))
        dgs.append((gn * x * inv).sum((0, 1, 2)))
    dqkv = torch.cat(parts + [dv.float().reshape(B, L, H * D)], -1)
    return dqkv, *dgs


@pytest.mark.parametrize("B,L,H,D", [(2, 300, 16, 64), (1, 77, 4, 12), (2, 65, 2, 96)])
def test_post_formula_holds_to_autograd(B, L, H, D):
    """the backward's emulation within GRAD_REL of the f32 autograd of the
    plain chain, as the plain bf16 autograd is"""
    qkv, qg, kg = _case(B, L, H, D, seed=D + 1)
    gen = torch.Generator().manual_seed(D)
    grads = [torch.randn(B, L, H, D, generator=gen).to(torch.bfloat16) for _ in range(3)]
    want = norm_rope.qk_post_plain(qkv.float(), *(g.float() for g in grads), qg, kg, H)
    got = _post_emulated(qkv, *grads, qg, kg, H)
    plain = norm_rope.qk_post_plain(qkv, *grads, qg, kg, H)
    for g, p, w in zip(got, plain, want):
        w = w.float()
        scale = w.abs().max().item()
        assert (g.float() - w).abs().max().item() <= GRAD_REL * scale
        assert (p.float() - w).abs().max().item() <= GRAD_REL * scale


# ---- on the card ----

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


# the sampler's B40 L759 and l320's B64 L320 at 16 x 64 heads; head dims
# 8 to 256 (and 6, 10: D/2 odd or not a multiple of 4) on short odd lengths
PREP_SHAPES = [(40, 759, 16, 64), (64, 320, 16, 64), (2, 77, 16, 8), (3, 65, 32, 12),
               (1, 1, 8, 32), (2, 33, 8, 96), (1, 129, 8, 128), (2, 31, 4, 256), (1, 19, 4, 6),
               (2, 7, 3, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,D", PREP_SHAPES)
def test_prep_kernel_matches_plain_on_gpu(B, L, H, D):
    """q and k within 4 ulp of the plain chain, v its exact copy, a rerun
    bit-identical, one counted launch"""
    _need_card()
    qkv, qg, kg = _case(B, L, H, D, "cuda", seed=B * L + D)
    before = _build.launches["qk_prep"]
    got = norm_rope.qk_prep_cuda(qkv, qg, kg, H)
    assert _build.launches["qk_prep"] == before + 1
    want = norm_rope.norm_rope_qkv_plain(qkv, qg, kg, H)
    for g, w in zip(got[:2], want[:2]):
        w = w.float()
        assert g.shape == (B, L, H, D) and g.dtype == torch.bfloat16 and g.is_contiguous()
        assert (g.float() - w).abs().max().item() <= _ulp_tol(w)
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got, norm_rope.qk_prep_cuda(qkv, qg, kg, H)))
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        norm_rope.norm_rope_qkv(qkv.float(), qg, kg, H)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,D", [(64, 320, 16, 64), (2, 77, 8, 96), (3, 65, 32, 12),
                                     (1, 40, 4, 256), (2, 19, 4, 6)])
def test_post_kernel_matches_autograd_on_gpu(B, L, H, D):
    """dqkv and both gain gradients within GRAD_REL of the f32 autograd of
    the plain chain, from contiguous gradients and from views of one packed
    buffer (as the long attention backward hands them over); a rerun
    bit-identical, one counted launch"""
    _need_card()
    qkv, qg, kg = _case(B, L, H, D, "cuda", seed=B * L + D)
    gen = torch.Generator(device="cuda").manual_seed(D)
    packed = torch.randn(B, L, 3, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    views = packed.unbind(2)
    want = norm_rope.qk_post_plain(qkv.float(), *(g.float() for g in views), qg, kg, H)
    before = _build.launches["qk_post"]
    got = norm_rope.qk_post_cuda(qkv, *views, qg, kg, H)
    assert _build.launches["qk_post"] == before + 1
    assert got[0].shape == qkv.shape and got[0].dtype == torch.bfloat16
    _grads_close(got, want)
    assert torch.equal(got[0][..., 2 * H * D:], packed[:, :, 2].reshape(B, L, H * D))
    again = norm_rope.qk_post_cuda(qkv, *(g.contiguous() for g in views), qg, kg, H)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_the_long_route_trains_through_both_passes_on_gpu():
    """16 x 64 heads at L 300 under autograd: one prep and one post launch,
    K7 with lse and the long backward once each, the q/k/v and gain
    gradients within GRAD_REL of the f32 plain layer's; under no_grad the
    prep pass alone"""
    _need_card()
    from osu_dreamer_tpu_torch.nn import attention as attn_mod

    gen = torch.Generator(device="cuda").manual_seed(12)
    attn = attn_mod.RoPEAttention(512, 16, 64, 512, torch.bfloat16).cuda()
    with torch.no_grad():
        for prm in attn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen, device="cuda") * prm.shape[0] ** -0.5
                      if prm.dim() == 2 else 1 + 0.1 * torch.randn(prm.shape, generator=gen,
                                                                   device="cuda"))
    x = torch.randn(2, 300, 512, generator=gen, device="cuda").to(torch.bfloat16)
    go = torch.randn(2, 300, 512, generator=gen, device="cuda")
    before = dict(_build.launches)
    got = torch.autograd.grad(attn(x), list(attn.parameters()), go.to(torch.bfloat16))
    counted = {k: _build.launches[k] - before[k] for k in _build.KERNELS}
    assert counted == dict(dict.fromkeys(_build.KERNELS, 0), qk_prep=1, qk_post=1,
                           flash_attention=1, long_attention_bwd=1)
    ref = attn_mod.RoPEAttention(512, 16, 64, 512, torch.float32).cuda()
    ref.load_state_dict(attn.state_dict())
    orig = attn_mod.long_flash_attention, attn_mod.norm_rope_qkv
    attn_mod.long_flash_attention = long_attention.attention_plain
    attn_mod.norm_rope_qkv = norm_rope.norm_rope_qkv_plain
    try:
        want = torch.autograd.grad(ref(x.float()), list(ref.parameters()), go)
    finally:
        attn_mod.long_flash_attention, attn_mod.norm_rope_qkv = orig
    _grads_close(got, want)
    before = dict(_build.launches)
    with torch.no_grad():
        attn(x)
    assert _build.launches["qk_prep"] == before["qk_prep"] + 1
    assert _build.launches["qk_post"] == before["qk_post"]
