"""The backward core's numerics (csrc/ffn_bwd_core.cuh: K3, K6, K5),
emulated on the CPU, and its plan and shared-memory arithmetic, before any
card runs them.

The core runs in four steps, and ``core_bwd_emulation`` follows them:
- pass A over the flat (B L) rows: the conv (bf16, the plain version's
  order; a tap across a batch row reads zero by a select; K3 first forms
  h1 = bf16(bf16(x / rms(x) g1 (1 + scale)) + shift) as K2 does), then per
  hidden chunk of 64 v | g = y W_vg + b in f32, s = v silu(g) in f32, the
  sums of s^2; K3 (the forward core) s W_out with s rounded to bf16, K6 and
  K5 (do known: the output gradient) the sums of dhn s, dhn = do W_out^T in
  f32; each hidden slice of the plan leaves its partials, summed in slice
  order;
- the row statistics: n = 1 / rms_H(s); K3's o = n (s W_out) + b_out and
  its block norm's backward in f32, do rounded to bf16, and
  m = mean_H(dhn s) = (1/H) do . (s W_out), so no pass forms dhn twice;
  K6's m = (1/H) sum dhn s;
- pass B per chunk: v | g and dhn = do W_out^T in f32, ds = n dhn - n^3 m s,
  dv = ds silu(g), dg = ds v silu'(g), dvg and hn = n s rounded to bf16,
  dY += dvg W_vg^T in f32, per hidden slice, summed in slice order;
- the finish: the transposed conv of dY, K3's FiLM and pre-norm backward
  (K2's arithmetic, f32), and the column sums; the weight gradients
  y^T dvg and hn^T do over the bf16 scratch, accumulated in f32.

It is held to f32 autograd of the plain version under the rule
chip_smoke.py and the card tests apply to the kernels (GRAD_REL: every
gradient's max abs error within 3 % of its largest f32 magnitude), next to
autograd of the plain version in bf16 under the same rule.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.ops import film_layer as fl
from osu_dreamer_tpu_torch.ops import swiglu as sw
from test_torch_modules import randn

torch.set_num_threads(1)

CHUNK = 64  # hidden columns per step of both passes
EPS = 1e-6
GRAD_REL = 0.03
H100_SMS = 132
BF = torch.bfloat16
CSRC = Path(sw.__file__).parent.parent / "csrc"


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF).float()


def _flat_conv(h: torch.Tensor, dww, dwb, L: int) -> torch.Tensor:
    """the depthwise conv over flat rows (B L, C) in bf16, each step rounded
    (the plain version's order); a tap across a batch row selects zero"""
    BL = h.shape[0]
    K = dww.shape[0]
    r = K // 2
    rows, pos = torch.arange(BL), torch.arange(BL) % L
    hb = h.to(BF)
    y = None
    for k in range(K):
        ok = (pos + k - r >= 0) & (pos + k - r < L)
        tap = torch.where(ok[:, None], hb[(rows + k - r).clamp(0, BL - 1)], torch.zeros((), dtype=BF))
        m = tap * dww[k].to(BF)
        y = m if y is None else y + m
    return (y + dwb.to(BF)).float()


def _transposed_conv(d: torch.Tensor, dww, L: int) -> torch.Tensor:
    """dh[q] = sum_k d[q - k + r] w_k within each batch row (f32)"""
    BL = d.shape[0]
    K = dww.shape[0]
    r = K // 2
    rows, pos = torch.arange(BL), torch.arange(BL) % L
    out = torch.zeros_like(d)
    for k in range(K):
        ok = (pos - k + r >= 0) & (pos - k + r < L)
        out = out + torch.where(ok[:, None], d[(rows - k + r).clamp(0, BL - 1)], 0.0) * dww[k]
    return out


def _taps(d: torch.Tensor, h: torch.Tensor, K: int, L: int) -> torch.Tensor:
    """d dw_kernel[k] = sum_p d[p] h[p + k - r] within each batch row"""
    BL = d.shape[0]
    r = K // 2
    rows, pos = torch.arange(BL), torch.arange(BL) % L
    out = []
    for k in range(K):
        ok = (pos + k - r >= 0) & (pos + k - r < L)
        src = torch.where(ok[:, None], h[(rows + k - r).clamp(0, BL - 1)], 0.0)
        out.append((d * src).sum(0))
    return torch.stack(out)


def _slices(nch: int, S: int) -> list[range]:
    return [range(s * nch // S, (s + 1) * nch // S) for s in range(S)]


def core_bwd_emulation(x, weights, go, film=None, slices=(1, 1)):
    """bf16 x, go (B, L, C); the SwiGLU weights (bf16 values in f32); K3's
    (scale, shift, gate, g1, g2) or None (K6, K5); (pass A, pass B) hidden
    slices -> the gradients in the order of ``film_layer_bwd_plain`` (K3) or
    ``swiglu_bwd_plain`` (K6, K5)"""
    dww, dwb, wvg, bvg, wout = weights[:5]
    B, L, C = x.shape
    H, K = wout.shape[0], dww.shape[0]
    BL, nch = B * L, -(-H // CHUNK)
    xf, gof = x.reshape(BL, C).float(), go.reshape(BL, C).float()
    bidx = torch.arange(BL) // L
    wv, wg, bv, bg = wvg[:, :H], wvg[:, H:], bvg[:H], bvg[H:]
    if film is not None:
        scale, shift, gate, g1, g2 = (t.float() for t in film)
        inv1 = torch.rsqrt(xf.square().mean(-1, keepdim=True) + EPS)
        a1 = g1 * (1 + scale[bidx])
        h1 = _bf(_bf(xf * inv1 * a1) + shift[bidx])
    else:
        h1 = xf
    y = _flat_conv(h1, dww, dwb, L)

    def cols(j):
        return slice(j * CHUNK, min(H, (j + 1) * CHUNK))

    def vgs(j):
        v, g = y @ wv[:, cols(j)] + bv[cols(j)], y @ wg[:, cols(j)] + bg[cols(j)]
        return v, g, torch.sigmoid(g)

    # pass A
    oa, ss, sd = torch.zeros(BL, C), torch.zeros(BL, 1), torch.zeros(BL, 1)
    for part in _slices(nch, slices[0]):
        o_s, ss_s, sd_s = torch.zeros(BL, C), torch.zeros(BL, 1), torch.zeros(BL, 1)
        for j in part:
            v, g, sig = vgs(j)
            s = v * g * sig
            ss_s = ss_s + s.square().sum(-1, keepdim=True)
            if film is None:
                sd_s = sd_s + ((gof @ wout[cols(j)].t()) * s).sum(-1, keepdim=True)
            else:
                o_s = o_s + _bf(s) @ wout[cols(j)]
        oa, ss, sd = oa + o_s, ss + ss_s, sd + sd_s
    # the row statistics
    n = torch.rsqrt(ss / H + EPS)
    if film is not None:
        o = oa * n + _bf(weights[5])
        n2 = torch.rsqrt(o.square().mean(-1, keepdim=True) + EPS)
        don = gof * (1 + gate[bidx]) * g2
        do = _bf(n2 * don - n2**3 * o * (don * o).mean(-1, keepdim=True))
        dgate = torch.zeros(B, C).index_add_(0, bidx, gof * o * n2 * g2)
        dg2 = (gof * (1 + gate[bidx]) * o * n2).sum(0)
        dbout = do.sum(0)
        coef = n**3 * (do * oa).sum(-1, keepdim=True) / H
    else:
        do = gof
        coef = n**3 * sd / H
    # pass B
    dY = torch.zeros(BL, C)
    dvg, hn = torch.zeros(BL, 2 * H), torch.zeros(BL, H)
    for part in _slices(nch, slices[1]):
        dY_s = torch.zeros(BL, C)
        for j in part:
            v, g, sig = vgs(j)
            sil = g * sig
            dhn = do @ wout[cols(j)].t()
            ds = n * dhn - coef * v * sil
            dv, dg = _bf(ds * sil), _bf(ds * v * sig * (1 + g * (1 - sig)))
            dvg[:, cols(j)], dvg[:, H:][:, cols(j)] = dv, dg
            hn[:, cols(j)] = _bf(n * v * sil)
            dY_s = dY_s + dv @ wv[:, cols(j)].t() + dg @ wg[:, cols(j)].t()
        dY = dY + dY_s
    # the finish
    dh1 = _transposed_conv(dY, dww, L)
    ddw, ddwb, dbvg = _taps(dY, h1, K, L), dY.sum(0), dvg.sum(0)
    dwvg, dwout = y.t() @ dvg, hn.t() @ do
    if film is None:
        return (_bf(dh1).reshape(B, L, C), ddw, ddwb, dwvg, dbvg, dwout, gof.sum(0))
    xn = xf * inv1
    dxn = dh1 * a1
    dx = gof + inv1 * dxn - inv1**3 * xf * (dxn * xf).mean(-1, keepdim=True)
    dshift = torch.zeros(B, C).index_add_(0, bidx, dh1)
    dscale = torch.zeros(B, C).index_add_(0, bidx, dh1 * xn * g1)
    dg1 = (dh1 * xn * (1 + scale[bidx])).sum(0)
    return (_bf(dx).reshape(B, L, C), dscale, dshift, dgate, dg1, dg2, ddw, ddwb, dwvg, dbvg,
            dwout, dbout)


def _weights(C: int, H: int, K: int, seed: int) -> list[torch.Tensor]:
    """the SwiGLU weights, bf16 values held in f32 (as the kernels cast them)"""
    raw = [randn(seed, K, C, scale=0.4), randn(seed + 1, C, scale=0.1),
           randn(seed + 2, C, 2 * H, scale=C**-0.5), randn(seed + 3, 2 * H, scale=0.1),
           randn(seed + 4, H, C, scale=H**-0.5), randn(seed + 5, C, scale=0.1)]
    return [_bf(torch.from_numpy(a)) for a in raw]


def _film(B: int, C: int, seed: int, zero: bool) -> list[torch.Tensor]:
    vecs = [torch.zeros(B, C) if zero else torch.from_numpy(randn(seed + i, B, C, scale=0.3))
            for i in range(3)]
    gains = [1 + torch.from_numpy(randn(seed + 3 + i, C, scale=0.1)) for i in range(2)]
    return [_bf(t) for t in vecs + gains]


def _plan_slices(B: int, L: int, C: int, H: int, film: bool) -> tuple[int, int]:
    _, sa, sb = sw.bwd_plan(B * L, C, -(-H // 64) * 64, H100_SMS, film)
    return sa, sb


def _hold(got, ref, plain) -> None:
    """each gradient of the emulation and of the plain bf16 autograd within
    GRAD_REL of the f32 gradient's largest magnitude"""
    for i, (g, r, p) in enumerate(zip(got, ref, plain)):
        g, r, p = g.float(), r.float(), p.float()
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), i
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() <= GRAD_REL * scale, (i, (g - r).abs().max().item(), scale)
        assert (p - r).abs().max().item() <= GRAD_REL * scale, (i, "plain", scale)


@pytest.mark.parametrize("B,L,C,H,zero_film", [
    (2, 77, 128, 341, False),   # latent width, ragged L, with FiLM
    (2, 77, 128, 341, True),    # zero FiLM
    (3, 40, 32, 85, False),     # narrowest: one 64-column box past C
    (1, 45, 384, 1024, False),  # widest the JAX package fuses: three dY column groups
    (1, 9, 128, 341, False),    # a ragged L shorter than a tile, every hidden chunk a slice
])
def test_film_layer_core_holds_the_grad_rule(B, L, C, H, zero_film):
    """K3 on the backward core at its widths, with the plan's hidden slices
    for this short input"""
    x = torch.from_numpy(randn(0, B, L, C)).to(BF)
    go = torch.from_numpy(randn(9, B, L, C)).to(BF)
    w, film = _weights(C, H, 5, 1), _film(B, C, 20, zero_film)
    slices = _plan_slices(B, L, C, H, True)
    got = core_bwd_emulation(x, w, go, film, slices)
    args = [x, *film, *w]
    ref = fl.film_layer_bwd_plain(*(t.float() for t in args), go.float())
    plain = fl.film_layer_bwd_plain(*(t.to(BF) for t in args), go)
    _hold(got, ref, plain)


@pytest.mark.parametrize("C,H", [(512, 1365), (640, 1706), (384, 1024)])
def test_swiglu_core_holds_the_grad_rule(C, H):
    """K6 at the denoiser's width and the widest it takes, K5 at the
    width-384 denoiser's (the same pass; its weight products on the GEMM)"""
    B, L = 2, 37
    x = torch.from_numpy(randn(2, B, L, C)).to(BF)
    go = torch.from_numpy(randn(3, B, L, C)).to(BF)
    w = _weights(C, H, 5, 4)
    got = core_bwd_emulation(x, w, go, None, _plan_slices(B, L, C, H, False))
    ref = sw.swiglu_bwd_plain(x.float(), *w[:5], go.float())
    plain = sw.swiglu_bwd_plain(x, *(t.to(BF) for t in w[:5]), go)
    _hold(got, ref, plain)


@pytest.mark.parametrize("film", [False, True])
def test_flat_rows_keep_batch_rows_apart(film):
    """64-row tiles over the flat rows straddle batch rows (3 x 40): a NaN
    in batch row 1 leaves the other rows' dx untouched (the conv and its
    transpose select zero across a batch row)"""
    B, L, C, H = 3, 40, 64, 170
    x = torch.from_numpy(randn(5, B, L, C)).to(BF)
    go = torch.from_numpy(randn(6, B, L, C)).to(BF)
    w = _weights(C, H, 5, 7)
    vecs = _film(B, C, 30, False) if film else None
    clean = core_bwd_emulation(x, w, go, vecs)[0]
    x[1] = float("nan")
    dirty = core_bwd_emulation(x, w, go, vecs)[0]
    assert torch.isnan(dirty[1]).any()
    assert torch.equal(dirty[0], clean[0]) and torch.equal(dirty[2], clean[2])


def test_emulation_slices_move_only_the_summation_order():
    """the hidden split (a plan for the short levels) changes only the order
    of f32 sums: within f32 rounding of the unsplit result"""
    B, L, C, H = 2, 30, 128, 341
    x = torch.from_numpy(randn(11, B, L, C)).to(BF)
    go = torch.from_numpy(randn(12, B, L, C)).to(BF)
    w, film = _weights(C, H, 5, 13), _film(B, C, 40, False)
    one = core_bwd_emulation(x, w, go, film, (1, 1))
    split = core_bwd_emulation(x, w, go, film, (6, 4))
    for a, b in zip(one[1:], split[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-4 * a.abs().max().item())


# ------------------------------------------------------------- the plan ----


@pytest.mark.parametrize("L", [38, 114, 342, 1026])
def test_bwd_plan_fills_the_card_at_the_latent_levels(L):
    """latent training's four levels (B 64, C 128, H 341 -> Hp 384): each
    pass runs on at least the card's SMs in CTAs (row tiles x column groups
    x hidden slices) where the six hidden chunks allow it; L 38 and 114 take
    64-row CTAs and a hidden split"""
    rows, Hp = 64 * L, 384
    nwg, sa, sb = sw.bwd_plan(rows, 128, Hp, H100_SMS, True)
    tiles = -(-rows // (64 * nwg))
    for s in (sa, sb):
        assert tiles * s >= H100_SMS or s == Hp // 64
    assert (nwg, sa, sb) == {38: (1, 4, 4), 114: (1, 2, 2), 342: (2, 1, 1), 1026: (2, 1, 1)}[L]


def test_bwd_plan_at_the_denoiser_widths():
    """B128 L152: C 512 (K6) takes 64-row CTAs, pass B's paired mode holds
    every dY column in one CTA, and the row tiles fill the card unsplit; so
    does C 384 (K5) with its three column groups; a short input splits both
    passes' hidden dimension as far as its chunks allow; C 640 runs
    128-column groups"""
    assert sw.bwd_plan(128 * 152, 512, 1408, H100_SMS, False) == (1, 1, 1)
    assert sw.bwd_plan(128 * 152, 384, 1024, H100_SMS, False) == (1, 1, 1)
    assert sw.bwd_plan(4 * 77, 512, 1408, H100_SMS, False)[1:] == (22, 22)
    assert sw.bwd_plan(4 * 77, 640, 1728, H100_SMS, False)[1:] == (27, 6)


def _c_expr(text: str) -> str:
    """a C++ integer expression of the headers as Python (``a < b ? c : d``
    of single names included)"""
    text = text.replace("sizeof(uint64_t)", "8").replace("sizeof(float)", "4")
    text = re.sub(r"\((?:size_t|int|uint64_t)\)", "", text).replace("/", "//")
    text = re.sub(r"(\w+) < (\w+) \? (\w+) : (\w+)", r"(\3 if \1 < \2 else \4)", text)
    return "(" + " ".join(text.split()) + ")"


def _header_consts(*names: str) -> dict:
    text = "".join((CSRC / f).read_text() for f in ("common.cuh", "ffn_core.cuh", "ffn_bwd_core.cuh"))
    return {name: eval(_c_expr(re.search(rf"constexpr \w+ {name} = ([^;]+);", text)[1]))
            for name in names}


def _header_bwd_stages(C: int, rw: int, pair: int, nloc: int) -> int:
    """``bwd_stages`` of csrc/ffn_bwd_core.cuh evaluated from the header's
    own expressions (``BgLayout`` at zero stages)"""
    src = (CSRC / "ffn_bwd_core.cuh").read_text()
    env = _header_consts("kBgStageBytes", "kBgMaxStages", "kFcTileBytes", "kMaxSmem")
    env.update(C=C, rw=rw, pair=pair, nloc=nloc, stages=0)
    body = re.search(r"BgLayout\(int C, int rw, int pair, int nloc, int stages\) \{(.*?)\}", src,
                     re.S)[1]
    for name, expr in re.findall(r"(\w+) = ([^;]+);", body):
        env[name] = eval(_c_expr(expr), env)
    n = (env["kMaxSmem"] - env["total"]) // env["kBgStageBytes"]
    return 0 if env["total"] > env["kMaxSmem"] else min(env["kBgMaxStages"], n)


@pytest.mark.parametrize("C,H", [(32, 85), (128, 341), (256, 682), (384, 1024), (448, 1194),
                                 (512, 1365), (640, 1706)])
def test_bwd_stages_mirror_the_header(C, H):
    """the Python copy of pass B's shared-memory arithmetic is the header's;
    every width the backward core takes keeps at least two ring stages in
    the mode ``ffn_backward`` picks (``pair``: past kBpFrom up to kBpCols)
    and in K6's statistics pass, with the whole hidden
    dimension in one slice; the paired mode's warpgroups hold at most NQ dY
    tiles each and cover all of C's"""
    names = ("kBgMaxStages", "kBgCols", "kBpFrom", "kBpCols", "kBmRows")
    consts = _header_consts(*names)
    assert tuple(consts[n] for n in names) == (sw._BG_MAX_STAGES, sw._BG_COLS, sw._BP_FROM,
                                               sw._BP_COLS, sw._BM_ROWS)
    src = (CSRC / "ffn_bwd_core.cuh").read_text()
    assert re.search(r"kBgStageBytes = (\d+) \* 1024;", src)[1] == str(sw._BG_STAGE_BYTES // 1024)
    rw = sw.bwd_plan(128 * 152, C, -(-H // 64) * 64, H100_SMS, False)[0]
    pair = sw._BP_FROM < C <= sw._BP_COLS
    assert "const bool pair = a.C > kBpFrom && a.C <= kBpCols;" in src
    nloc = -(-H // 64)
    assert sw.bwd_stages(C, rw, pair, nloc) == _header_bwd_stages(C, rw, int(pair), nloc) >= 2
    assert sw.bwd_stages(C, rw, False, nloc) == _header_bwd_stages(C, rw, 0, nloc) >= 2
    if pair:
        kt = -(-C // 64)
        half = eval(_c_expr(re.search(r"const int half = ([^;]+);", src)[1]), {"kt": kt})
        nq = eval(_c_expr(re.search(r"NQ = PAIR \? ([^:]+) :", src)[1]), consts)
        assert max(half, kt - half) <= nq and half + (kt - half) == kt and kt - half >= 1


@pytest.mark.parametrize("R,S", [(65664, 22), (2432, 132), (100, 5), (640, 6)])
def test_gemm_chunks_are_never_empty(R, S):
    """csrc/gemm_tn.cuh: ``gemm_chunks`` and the launch's rows a chunk,
    evaluated from the header's own expressions: at most ``S`` chunks (the
    partials ``gemm_splits`` sizes) of whole 64-row blocks that cover the R
    rows, none empty"""
    src = (CSRC / "gemm_tn.cuh").read_text()
    body = re.search(r"inline int gemm_chunks\(int R, int S\) \{(.*?)\n\}", src, re.S)[1]
    env = {"R": R, "S": S}
    for name, expr in re.findall(r"(\w+) = ([^;,]+(?:\?[^;,]+)?)[;,]", body):
        env[name] = eval(_c_expr(expr), env)
    chunks = eval(_c_expr(re.search(r"return ([^;]+);", body)[1]), env)
    launch = src[src.index("inline cudaError_t gemm_tn_splitk"):]
    assert "const int chunks = gemm_chunks(R, S);" in launch
    per = eval(_c_expr(re.search(r"const int per = ([^;]+);", launch)[1]), {"R": R, "chunks": chunks})
    rows = [(s * per * 64, min(R, (s + 1) * per * 64)) for s in range(chunks)]
    assert 1 <= chunks <= S
    assert all(r0 < r1 for r0, r1 in rows) and rows[-1][1] == R
    assert all(rows[i][1] == rows[i + 1][0] for i in range(chunks - 1))
