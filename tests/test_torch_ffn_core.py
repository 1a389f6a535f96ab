"""The forward core's numerics (csrc/ffn_core.cuh, K4 and K2), emulated on
the CPU, and its packed-weight cache, before any card runs them.

The kernel computes the depthwise conv as the plain version does (bf16, each
step rounded), then streams the hidden dimension in chunks of HIDDEN_CHUNK:
v | g = y W_vg + b in f32, h = v silu(g) in f32, the row sums of h^2 in
f32 (chunk by chunk, in order), h rounded to bf16 for o += h W_out in f32.
Where the hidden dimension is split across CTAs each slice of chunks leaves
its own partial o and sum of squares, and the slices are summed in slice
order. 1/rms(h) scales o at the end (deferred: it commutes with the
product), then the bias, one rounding to bf16. ``core_emulation`` does the
same in torch. It is held to an f64 reference of the same function under the
rule chip_smoke.py applies to the kernel on the card: its error's mean
within 1.1x and its max within 1.5x of the plain bf16 path's.
"""

from __future__ import annotations

import gc
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.ops import film_layer as fl
from osu_dreamer_tpu_torch.ops import swiglu as sw
from test_torch_modules import randn

torch.set_num_threads(1)

HIDDEN_CHUNK = 64  # hidden columns per step of csrc/ffn_core.cuh
MEAN_RATIO, MAX_RATIO = 1.1, 1.5
H100_SMS = 132
CSRC = Path(sw.__file__).parent.parent / "csrc"


def _weights(C: int, H: int, K: int, seed: int) -> list[torch.Tensor]:
    """the SwiGLU weights, bf16 values held in f32 (as the kernels cast them)"""
    raw = [randn(seed, K, C, scale=0.4), randn(seed + 1, C, scale=0.1),
           randn(seed + 2, C, 2 * H, scale=C**-0.5), randn(seed + 3, 2 * H, scale=0.1),
           randn(seed + 4, H, C, scale=H**-0.5), randn(seed + 5, C, scale=0.1)]
    return [torch.from_numpy(a).to(torch.bfloat16).float() for a in raw]


def core_emulation(x: torch.Tensor, weights, slices: int) -> torch.Tensor:
    """bf16 (B, L, C) -> bf16 (B, L, C), the forward core's arithmetic"""
    dww, dwb, wvg, bvg, wout, bout = weights
    B, L, C = x.shape
    H = wout.shape[0]
    K = dww.shape[0]
    r = K // 2
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    bf = torch.bfloat16
    # the conv, each step rounded to bf16 (the plain version's order)
    y = xp[:, 0:L] * dww[0].to(bf)
    for k in range(1, K):
        y = y + xp[:, k : k + L] * dww[k].to(bf)
    y = (y + dwb.to(bf)).float()
    nch = -(-H // HIDDEN_CHUNK)
    o_total = torch.zeros(B, L, C)
    ss_total = torch.zeros(B, L, 1)
    for s in range(slices):
        o = torch.zeros(B, L, C)
        ss = torch.zeros(B, L, 1)
        for j in range(s * nch // slices, (s + 1) * nch // slices):
            cols = slice(j * HIDDEN_CHUNK, min(H, (j + 1) * HIDDEN_CHUNK))
            v = y @ wvg[:, :H][:, cols] + bvg[:H][cols]
            g = y @ wvg[:, H:][:, cols] + bvg[H:][cols]
            h = v * g * torch.sigmoid(g)
            ss = ss + h.square().sum(-1, keepdim=True)
            o = o + h.to(bf).float() @ wout[cols]
        o_total = o_total + o
        ss_total = ss_total + ss
    return (o_total * torch.rsqrt(ss_total / H + 1e-6) + bout).to(bf)


def _reference(x, weights) -> torch.Tensor:
    """the function in f64 on the same (bf16-valued) inputs"""
    return sw.swiglu_plain(x.double(), *(w.double() for w in weights))


@pytest.mark.parametrize("C,H", [(128, 341), (512, 1365), (1024, 2730)])
@pytest.mark.parametrize("split", [False, True])
def test_core_numerics_hold_the_kernel_rule(C, H, split):
    """the emulated kernel against the f64 reference, beside the plain bf16
    path: within 1.1x (mean) and 1.5x (max) of its error, with the hidden
    dimension in one slice and in the slices fwd_plan gives a short input"""
    x = torch.from_numpy(randn(0, 2, 40, C)).to(torch.bfloat16)
    w = _weights(C, H, 5, 1)
    Hp = -(-H // 64) * 64
    slices = sw.fwd_plan(2 * 40, C, Hp, H100_SMS)[1] if split else 1
    assert slices > 1 or not split
    ref = _reference(x, w)
    got = core_emulation(x, w, slices).double()
    plain = sw.swiglu_plain(x, *(t.to(torch.bfloat16) for t in w)).double()
    ek, ep = (got - ref).abs(), (plain - ref).abs()
    assert ek.mean() <= MEAN_RATIO * ep.mean(), (ek.mean(), ep.mean())
    assert ek.max() <= MAX_RATIO * ep.max(), (ek.max(), ep.max())


def test_fwd_plan_fills_the_card_at_the_serving_shape():
    """B4 L759 C512 (the sampler's denoiser FFN): 24 row tiles x 2 column
    groups split the hidden in two, 96 CTAs on 132 SMs; B128 L152 needs no
    split; the latent film layer holds whole rows (128 columns)"""
    assert sw.fwd_plan(4 * 759, 512, 1408, H100_SMS) == (256, 2)
    assert sw.fwd_plan(128 * 152, 512, 1408, H100_SMS) == (256, 1)
    assert sw.fwd_plan(4 * 20493, 128, 384, H100_SMS, film=True) == (128, 1)
    assert sw.fwd_plan(64 * 38, 128, 384, H100_SMS, film=True) == (128, 6)
    # a card of fewer SMs splits less
    assert sw.fwd_plan(4 * 759, 512, 1408, 78) == (256, 1)


@pytest.mark.parametrize("C,fits", [(16, True), (32, True), (64, True), (96, True), (128, True),
                                    (512, True), (640, True), (1024, True), (1216, False),
                                    (24, False)])
def test_fwd_kernel_range(C, fits):
    """the forward core takes C a multiple of 16 (its 64-column boxes
    zero-filled past C) while its y tiles leave two 18 KB ring stages of
    227 KB of shared memory (one consumer warpgroup past C 512)"""
    assert sw.fwd_kernel_fits(C, 5, int(C * 8 / 3)) == fits
    assert not sw.fwd_kernel_fits(128, 11, 341)  # radius 5 > the window's halo


def _c_expr(text: str) -> str:
    """a C++ integer expression of csrc/ffn_core.cuh as Python"""
    text = re.sub(r"\(size_t\)", "", text)
    text = text.replace("sizeof(uint64_t)", "8").replace("/", "//")
    text = re.sub(r"\((\w+) \? ([^:]+) : ([^)]+)\)", r"((\2) if \1 else (\3))", text)
    return "(" + " ".join(text.split()) + ")"


def _header_stages(C: int, K: int, H: int) -> int:
    """``ffn_stages`` of csrc/ffn_core.cuh at the film layer's largest
    vectors (nloc = Hp / 64, no residual rows), evaluated from the header's
    own expressions"""
    src = (CSRC / "ffn_core.cuh").read_text() + (CSRC / "common.cuh").read_text()
    env = {name: eval(_c_expr(re.search(rf"constexpr \w+ {name} = ([^;]+);", src)[1]))
           for name in ("kFcMaxStages", "kFcStageBytes", "kFcTileBytes", "kMaxSmem")}
    env.update(C=C, K=K, nloc=-(-H // 64), film=True, nwg=2 if C <= 512 else 1)
    n = eval(_c_expr(re.search(r"const size_t n = ([^;]+);", src)[1]), env)
    env["ring"] = eval(_c_expr(re.search(r"\bring = ([^;]+);", src)[1]), env)
    env["xres"] = env["ring"]  # zero stages
    env["params"] = env["xres"]  # no residual rows
    env["rinv"] = env["params"] + (n + 1023) // 1024 * 1024
    env["bars"] = eval(_c_expr(re.search(r"\bbars = ([^;]+);", src)[1]), env)
    fixed = eval(_c_expr(re.search(r"\btotal = ([^;]+);", src)[1]), env)
    if fixed > env["kMaxSmem"]:
        return 0
    return min(env["kFcMaxStages"], (env["kMaxSmem"] - fixed) // env["kFcStageBytes"])


@pytest.mark.parametrize("C,H", [(16, 42), (128, 341), (512, 1365), (640, 1706), (1024, 2730),
                                 (1216, 3242)])
def test_fwd_stages_mirror_the_header(C, H):
    """the Python copy of the core's shared-memory arithmetic (which routes
    a width to the kernel or to the plain version) is the header's, so the
    two cannot drift apart unseen"""
    assert sw.fwd_stages(C, 5, H) == _header_stages(C, 5, H)
    src = (CSRC / "ffn_core.cuh").read_text()
    assert re.search(r"kFcMaxRadius = (\d+);", src)[1] == str(sw._FC_MAX_RADIUS)
    assert re.search(r"kFcMaxStages = (\d+);", src)[1] == str(sw._FC_MAX_STAGES)


# ---------------------------------------------------------------- packs ----


def _params(C: int = 64, H: int = 42, K: int = 5, seed: int = 0) -> list[torch.nn.Parameter]:
    """the five weights the pack holds (the output bias is passed apart)"""
    return [torch.nn.Parameter(torch.from_numpy(a)) for a in
            (randn(seed, K, C), randn(seed + 1, C), randn(seed + 2, C, 2 * H),
             randn(seed + 3, 2 * H), randn(seed + 4, H, C))]


def test_pack_cache_returns_the_cached_layout():
    """one pack a weight version, read by the forward and the backward
    kernels alike: the backward's lookup (the same five weights) hits the
    forward's layout"""
    p = _params()
    a = sw.packed_ffn_weights(*p, torch.bfloat16)
    assert sw.packed_ffn_weights(*p, torch.bfloat16) is a
    assert set(sw._PACKS[p[2]]) == {("ffn", torch.bfloat16)}
    # another dtype is another layout
    assert sw.packed_ffn_weights(*p, torch.float32) is not a


def test_out_bias_is_cast_once_per_version():
    """the forward wrappers' bf16 b_out: one cast a version of the f32
    parameter, kept beside W_vg's pack and apart from it (so the backward's
    lookup of the five weights still hits the forward's pack)"""
    p = _params()
    bias = torch.nn.Parameter(torch.from_numpy(randn(9, 64)))
    a = sw.packed_out_bias(bias, p[2], torch.bfloat16)
    assert sw.packed_out_bias(bias, p[2], torch.bfloat16) is a
    assert a.dtype == torch.bfloat16 and torch.equal(a, bias.detach().to(torch.bfloat16))
    sw.packed_ffn_weights(*p, torch.bfloat16)
    assert set(sw._PACKS[p[2]]) == {("bout", torch.bfloat16), ("ffn", torch.bfloat16)}
    with torch.no_grad():
        bias.add_(1.0)
    b = sw.packed_out_bias(bias, p[2], torch.bfloat16)
    assert b is not a and torch.equal(b, bias.detach().to(torch.bfloat16))


def test_pack_cache_repacks_after_an_in_place_update():
    p = _params()
    a = sw.packed_ffn_weights(*p, torch.bfloat16)
    with torch.no_grad():
        p[2].add_(1.0)
    b = sw.packed_ffn_weights(*p, torch.bfloat16)
    assert b is not a
    torch.testing.assert_close(b.wvg_t[:42], p[2][:, :42].t().to(torch.bfloat16))


def test_pack_cache_repacks_after_an_optimizer_step():
    p = _params()
    a = sw.packed_ffn_weights(*p, torch.bfloat16)
    opt = torch.optim.AdamW(p, lr=1e-2)
    sum(t.square().sum() for t in p).backward()
    opt.step()
    b = sw.packed_ffn_weights(*p, torch.bfloat16)
    assert b is not a
    torch.testing.assert_close(b.wout_t[:, :42], p[4].t().to(torch.bfloat16))
    torch.testing.assert_close(b.dww, p[0].to(torch.bfloat16))
    assert sw.packed_ffn_weights(*p, torch.bfloat16) is b


def test_pack_cache_misses_a_new_tensor():
    """a tensor made anew (possibly at a freed tensor's address, at version
    0) is a new key, never a stale hit"""
    p = _params()
    a = sw.packed_ffn_weights(*p, torch.bfloat16)
    q = [torch.nn.Parameter(t.detach().clone()) for t in p]
    assert sw.packed_ffn_weights(*q, torch.bfloat16) is not a


def test_pack_pads_the_hidden_with_zeros():
    """H 42 pads to 64: the padded rows of W_vg^T (both halves), columns of
    W_out^T and entries of b_vg are zero; the rest is the weights, cast"""
    p = _params()
    pk = sw.packed_ffn_weights(*p, torch.bfloat16)
    H, Hp = 42, 64
    assert (pk.H, pk.Hp) == (H, Hp)
    assert pk.wvg_t.shape == (2 * Hp, 64) and pk.wout_t.shape == (64, Hp)
    assert not pk.wvg_t[H:Hp].any() and not pk.wvg_t[Hp + H:].any()
    assert not pk.wout_t[:, H:].any()
    assert not pk.bvg[H:Hp].any() and not pk.bvg[Hp + H:].any()
    bf = torch.bfloat16
    torch.testing.assert_close(pk.wvg_t[Hp : Hp + H], p[2][:, H:].t().to(bf))
    torch.testing.assert_close(pk.bvg[:H], p[3][:H].to(bf).float())
    torch.testing.assert_close(pk.bvg[Hp : Hp + H], p[3][H:].to(bf).float())


def test_pack_cache_lets_the_weights_go():
    """the cache holds its layouts by the W_vg tensor, weakly: no size
    bound, and a dropped weight takes its layouts with it"""
    p = _params(C=32, H=21)
    sw.packed_ffn_weights(*p, torch.bfloat16)
    sw.packed_ffn_weights(*p, torch.float32)
    assert set(sw._PACKS[p[2]]) == {("ffn", torch.bfloat16), ("ffn", torch.float32)}
    before = len(sw._PACKS)
    del p
    gc.collect()
    assert len(sw._PACKS) == before - 1


def test_pack_skips_inference_tensors():
    """inference tensors keep no version counter: packed anew every call"""
    with torch.inference_mode():
        p = [t.detach().clone() for t in _params()]
    assert sw.packed_ffn_weights(*p, torch.bfloat16) is not sw.packed_ffn_weights(
        *p, torch.bfloat16)


def test_film_layer_backward_widths():
    """K3's range: every width the JAX package fuses (to C 384); the
    backward core's pass B with two 64-row warpgroups a CTA to C 256 and
    one at C 384 (its y and do tiles), always at least two ring stages"""
    assert [C for C in (32, 64, 96, 128, 256, 384, 512) if fl.bwd_kernel_fits(C, 5)] == [
        32, 64, 128, 256, 384]
    rows = 64 * 1026  # latent training's top level: enough row tiles
    assert [sw.bwd_plan(rows, C, -(-int(C * 8 / 3) // 64) * 64, H100_SMS, True)[0]
            for C in (64, 128, 256, 384)] == [2, 2, 2, 1]
    for C in fl.BWD_WIDTHS:
        Hp = -(-int(C * 8 / 3) // 64) * 64
        assert sw.bwd_stages(C, 2 if C <= 256 else 1, False, Hp // 64) >= 2


def test_emulation_matches_the_plain_version_closely():
    """a sanity check of the emulation itself: the same function (within
    bf16 rounding of the plain path)"""
    x = torch.from_numpy(randn(3, 1, 20, 64)).to(torch.bfloat16)
    w = _weights(64, 42, 3, 4)
    got = core_emulation(x, w, 1).float()
    want = _reference(x, w).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.05, rtol=0.02)
