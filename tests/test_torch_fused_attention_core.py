"""The fused norm + RoPE attention kernels' numerics (csrc/fused_attention.cu:
K9 forward, K10 backward), emulated on the CPU in their tile order, and
their shared-memory and register plan, before any card runs them.

The forward (``fwd_emulation``), per (batch row, head) and 64-row query
tile: q and k normalised and rotated once (f32 1/rms, bf16(x / rms),
bf16(* gamma), bf16 rotary products and sums); a first sweep of S tiles for
each row's maximum and sum (log2 units, as the kernel's ex2); a second
sweep of 32-key halves forming P = exp(s - m) / l, normalised before its
single bf16 rounding, and O += P V in f32. It is held to
``rope_attention_plain`` in bf16 under chip_smoke.py's forward rule (4 ulp
of the output's largest magnitude).

The backward (``bwd_emulation``): rq/rk recomputed by the forward's own
normalisation (the residual contract: the forward saves only lse), delta =
rowsum(dO O); per 64-key tile and query tile S^T and dP^T, P^T = exp(S^T
scale - lse), dS^T = P^T (dP^T - delta) scale (exactly 0 at L = 1, a softmax
over one key), both rounded to bf16 once,
dV += P^T dO and dK += dS^T Q in f32, each dS^T tile stored; dQ from the
stored tiles in the kernel's order (two passes of two key tiles at L >
192); the tiled norm + RoPE backward in f32. It is held to f32 autograd of
``rope_attention_plain`` under GRAD_REL (every gradient's max abs error
within 3 % of its largest f32 magnitude), next to the plain bf16 autograd
under the same rule.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from osu_dreamer_tpu_torch.ops import fused_attention as fa
from test_torch_modules import N, T

torch.set_num_threads(1)

BF = torch.bfloat16
TILE = 64
D = 64
EPS = 1e-6
LOG2E = 1.4426950408889634
NEG = -1e30
SCALE = D**-0.5
GRAD_REL = 0.03
BF16_ULPS = 4
MAX_SMEM = 232448   # a block's shared memory on an H100
SM_SMEM = 233472    # an SM's (228 KB), of which each resident block reserves 1 KB
SM_REGS = 65536
CSRC = Path(fa.__file__).parent.parent / "csrc"

# (B, L, H): the training shape's length at two heads, one row, and the
# ragged edges of one, two, three and four 64-row tiles
SHAPES = [(2, 152, 2), (1, 1, 1), (1, 63, 1), (1, 64, 1), (1, 65, 1), (1, 192, 1), (1, 193, 1),
          (1, 256, 1)]


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF).float()


def _inputs(B: int, L: int, H: int, seed: int = 0, d: int = D):
    """bf16 qkv and output gradient, gammas holding bf16 values (as the
    kernels read them), from a numpy seed; head dim ``d``"""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(0.7 * rng.standard_normal((B, L, 3 * H * d), dtype=np.float32)).to(BF)
    qg, kg = (_bf(torch.from_numpy(1 + 0.2 * rng.standard_normal(d, dtype=np.float32)))
              for _ in range(2))
    go = torch.from_numpy(rng.standard_normal((B, L, H * d), dtype=np.float32)).to(BF)
    return qkv, qg, kg, go


def _heads(x: torch.Tensor, H: int, part: int, d: int = D) -> torch.Tensor:
    """part (0 q, 1 k, 2 v) of packed (B, L, n H d) as (B, H, L, d) f32"""
    B, L, _ = x.shape
    return x[..., part * H * d:(part + 1) * H * d].reshape(B, L, H, d).permute(0, 2, 1, 3).float()


def _pad(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """rows past L of (..., L) or (..., L, D) as the kernels see them"""
    if x.dim() == 3:
        return F.pad(x, (0, rows - x.shape[-1]), value=value)
    return F.pad(x, (0, 0, 0, rows - x.shape[-2]), value=value)


def _tables(L: int, d: int = D) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = fa.rope_tables(L, d, "cpu", BF)
    return cos.float(), sin.float()


def norm_rope_emulation(x: torch.Tensor, gamma: torch.Tensor):
    """``norm_rope_tiles``: raw rows (B, H, L, D) -> (rotated rows, 1/rms)"""
    L, D = x.shape[-2:]
    inv = 1.0 / torch.sqrt(x.square().sum(-1) / D + EPS)
    n = _bf(_bf(x * inv[..., None]) * gamma.float())
    n1, n2 = n[..., :D // 2], n[..., D // 2:]
    c, s = _tables(L, D)
    r = torch.cat([_bf(_bf(n1 * c) - _bf(n2 * s)), _bf(_bf(n1 * s) + _bf(n2 * c))], -1)
    return r, inv


def fwd_emulation(qkv: torch.Tensor, qg, kg, H: int):
    """K9's order -> (out bf16 (B, L, H D), lse (B, H, L))"""
    B, L, _ = qkv.shape
    D = qkv.shape[-1] // (3 * H)
    SCALE = D**-0.5
    nt = -(-L // TILE)
    Lp = nt * TILE
    rq, _ = norm_rope_emulation(_heads(qkv, H, 0, D), qg)
    rk, _ = norm_rope_emulation(_heads(qkv, H, 1, D), kg)
    rq, rk, v = _pad(rq, Lp), _pad(rk, Lp), _pad(_heads(qkv, H, 2, D), Lp)
    c2 = SCALE * LOG2E
    keys = torch.arange(Lp)
    out, lse = torch.zeros(B, H, Lp, D), torch.zeros(B, H, Lp)
    for w in range(nt):
        qw = rq[..., w * TILE:(w + 1) * TILE, :]
        m, l = torch.full((B, H, TILE), NEG), torch.zeros(B, H, TILE)
        for t in range(nt):  # sweep 1: row maxima and sums, online
            s = qw @ rk[..., t * TILE:(t + 1) * TILE, :].transpose(-1, -2)
            s = torch.where(keys[t * TILE:(t + 1) * TILE] < L, s, NEG)
            mx = torch.maximum(m, s.amax(-1))
            l = l * torch.exp2((m - mx) * c2) + torch.exp2(s * c2 - (mx * c2)[..., None]).sum(-1)
            m = mx
        o = torch.zeros(B, H, TILE, D)
        for k0 in range(0, Lp, TILE // 2):  # sweep 2: 32 keys at a time
            if k0 >= L:
                continue
            s = qw @ rk[..., k0:k0 + TILE // 2, :].transpose(-1, -2)
            p = torch.exp2(s * c2 - (m * c2)[..., None]) * (1.0 / l)[..., None]
            p = torch.where(keys[k0:k0 + TILE // 2] < L, p, 0.0)
            o = o + _bf(p) @ v[..., k0:k0 + TILE // 2, :]
        out[..., w * TILE:(w + 1) * TILE, :] = o
        lse[..., w * TILE:(w + 1) * TILE] = m * SCALE + torch.log(l)
    out = out[..., :L, :].permute(0, 2, 1, 3).reshape(B, L, H * D).to(BF)
    return out, lse[..., :L]


def norm_rope_bwd_emulation(d: torch.Tensor, x: torch.Tensor, inv: torch.Tensor, gamma):
    """``norm_rope_bwd_tile``: the f32 gradient of the rotated rows back
    through the inverse rotation and the gamma-scaled RMS norm ->
    (dx f32 (B, H, L, D), the gamma gradient (D,))"""
    D = x.shape[-1]
    c, s = _tables(x.shape[-2], D)
    d1, d2 = d[..., :D // 2], d[..., D // 2:]
    gn = torch.cat([d1 * c + d2 * s, d2 * c - d1 * s], -1)
    iv = inv[..., None]
    dgamma = (gn * x * iv).sum((0, 1, 2))
    gh = gn * gamma.float()
    m = (gh * x).sum(-1, keepdim=True) / D
    return gh * iv - x * iv**3 * m, dgamma


def bwd_emulation(qkv: torch.Tensor, go: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, qg,
                  kg, H: int, streamed: bool = False):
    """K10's order -> (dqkv bf16, dq_gamma, dk_gamma); at head dim 128 the
    two launches' order: dK and dV a key tile against every query tile, dQ
    a query tile against every key tile from dS formed again (S and dP as
    Q K^T and dO V^T), no dS tile stored. ``streamed``: the same two
    launches' order on csrc/attention_stream.cu, the rotated rows and dO
    zero-padded to whole 64-column boxes (the prep pass's padding and the
    tensor map's fill), the gradients cut back to D for the post pass"""
    B, L, _ = qkv.shape
    D = qkv.shape[-1] // (3 * H)
    SCALE = D**-0.5
    nt = -(-L // TILE)
    nw = 2 if nt == 4 else nt  # consumer warpgroups: one key tile each, a pass
    two_launch = D == 128 or streamed
    if two_launch:
        nw = nt  # one CTA a key tile, one pass
    Lp = nt * TILE
    q, k = _heads(qkv, H, 0, D), _heads(qkv, H, 1, D)
    rq, iq = norm_rope_emulation(q, qg)  # recomputed: the forward's own rounding
    rk, ik = norm_rope_emulation(k, kg)
    rq, rk, v = _pad(rq, Lp), _pad(rk, Lp), _pad(_heads(qkv, H, 2, D), Lp)
    do, o = _pad(_heads(go, H, 0, D), Lp), _pad(_heads(out, H, 0, D), Lp)
    if streamed:
        boxes = -(-D // 64) * 64
        rq, rk, v, do, o = (F.pad(t, (0, boxes - D)) for t in (rq, rk, v, do, o))
    delta = (do * o).sum(-1)
    lse2 = _pad(lse * LOG2E, Lp, float("inf"))
    c2 = SCALE * LOG2E
    ds_scale = SCALE if L > 1 else 0.0  # a softmax over one key: dS is exactly 0

    def tile(x: torch.Tensor, i: int) -> torch.Tensor:
        return x[..., i * TILE:(i + 1) * TILE, :]

    dq, dk, dv = (torch.zeros(B, H, Lp, rq.shape[-1]) for _ in range(3))
    for p in range(nt // nw):
        stored = {}
        for w in range(nw):  # phase A: key tile kt against every query tile
            kt = p * nw + w
            key_ok = (kt * TILE + torch.arange(TILE) < L)[:, None]
            for j in range(nt):
                st = tile(rk, kt) @ tile(rq, j).transpose(-1, -2)
                dpt = tile(v, kt) @ tile(do, j).transpose(-1, -2)
                lj = lse2[..., j * TILE:(j + 1) * TILE, None].transpose(-1, -2)
                pt = torch.where(key_ok, torch.exp2(st * c2 - lj), 0.0)
                dst = _bf(pt * (dpt - delta[..., None, j * TILE:(j + 1) * TILE]) * ds_scale)
                dv[..., kt * TILE:(kt + 1) * TILE, :] += _bf(pt) @ tile(do, j)
                dk[..., kt * TILE:(kt + 1) * TILE, :] += dst @ tile(rq, j)
                stored[w, j] = dst
        for j in range(nt):  # phase B: dQ from the stored dS^T tiles
            for w in range(nw):
                if two_launch:  # the dQ launch: dS_j,t formed again from Q_j K_t^T, dO_j V_t^T
                    t = p * nw + w
                    s = tile(rq, j) @ tile(rk, t).transpose(-1, -2)
                    dp = tile(do, j) @ tile(v, t).transpose(-1, -2)
                    key_ok = t * TILE + torch.arange(TILE) < L
                    pr = torch.where(key_ok, torch.exp2(s * c2 - lse2[..., j * TILE:(j + 1) * TILE, None]), 0.0)
                    ds = _bf(pr * (dp - delta[..., j * TILE:(j + 1) * TILE, None]) * ds_scale)
                    dq[..., j * TILE:(j + 1) * TILE, :] += ds @ tile(rk, t)
                    continue
                dq[..., j * TILE:(j + 1) * TILE, :] += stored[w, j].transpose(-1, -2) @ tile(rk, p * nw + w)
    dxq, dgq = norm_rope_bwd_emulation(dq[..., :L, :D], q, iq, qg)
    dxk, dgk = norm_rope_bwd_emulation(dk[..., :L, :D], k, ik, kg)
    dqkv = torch.cat([t.permute(0, 2, 1, 3).reshape(B, L, H * D)
                      for t in (dxq, dxk, dv[..., :L, :D])], -1)
    return dqkv.to(BF), dgq, dgk


def _ulp_tol(want: torch.Tensor) -> float:
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)


@pytest.mark.parametrize("B,L,H", SHAPES)
def test_forward_emulation_holds_the_plain_rule(B, L, H):
    """K9's order against ``rope_attention_plain`` in bf16: out within 4 ulp
    of its largest magnitude, lse against the plain forward's (f32)"""
    qkv, qg, kg, _ = _inputs(B, L, H, seed=L)
    out, lse = fwd_emulation(qkv, qg, kg, H)
    want, want_lse = fa.fused_attention_fwd_plain(qkv, qg, kg, H)
    assert out.shape == want.shape and lse.shape == want_lse.shape == (B, H, L)
    assert (out.float() - want.float()).abs().max().item() <= _ulp_tol(want.float())
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=0)


@pytest.mark.parametrize("B,L,H", SHAPES)
def test_backward_emulation_holds_grad_rel(B, L, H):
    """K10's order against f32 autograd of the plain version: every gradient
    within GRAD_REL of its largest f32 magnitude, as the plain bf16 autograd
    is"""
    qkv, qg, kg, go = _inputs(B, L, H, seed=1000 + L)
    out, lse = fwd_emulation(qkv, qg, kg, H)
    got = bwd_emulation(qkv, go, out, lse, qg, kg, H)
    ref = fa.fused_attention_bwd_plain(qkv.float(), go.float(), out, lse, qg, kg, H)
    plain = fa.fused_attention_bwd_plain(qkv, go, out, lse, qg, kg, H)
    for name, g, r, p in zip(("dqkv", "dq_gamma", "dk_gamma"), got, ref, plain):
        g, r, p = g.float(), r.float(), p.float()
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        scale = r.abs().max().item()
        assert (g - r).abs().max().item() <= GRAD_REL * scale, name
        assert (p - r).abs().max().item() <= GRAD_REL * scale, name


def test_norm_rope_emulation_is_the_plain_rotation():
    """``norm_rope_tiles``' order (f32 1/rms, then the bf16 roundings of the
    plain version), which both kernels run so that the backward recomputes
    the forward's rq/rk: within one bf16 rounding of ``rope(rms_norm(.))``,
    and its 1/rms that of ``rms_norm``'s f32 statistics"""
    qkv, qg, _, _ = _inputs(2, 77, 2, seed=3)
    q = _heads(qkv, 2, 0)
    got, inv = norm_rope_emulation(q, qg)
    plain = fa.rope(fa.rms_norm(q.to(BF).permute(0, 2, 1, 3), qg)).permute(0, 2, 1, 3).float()
    assert (got - plain).abs().max().item() <= 2.0 ** (np.floor(np.log2(plain.abs().max().item())) - 7)
    torch.testing.assert_close(inv, torch.rsqrt(q.square().mean(-1) + EPS), rtol=1e-6, atol=0)


# ---- the plan: the kernels' shared memory and registers, from the source ----

def _cu() -> str:
    return (CSRC / "fused_attention.cu").read_text()


def _split_ternary(expr: str):
    """(cond, then, else) of the top-level ``a ? b : c`` of ``expr``, None
    without one (parentheses and nested ternaries respected)"""
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0 and ch == "?" and q is None:
            q, pending = i, 0
        elif depth == 0 and q is not None and ch == "?":
            pending += 1
        elif depth == 0 and q is not None and ch == ":":
            if pending == 0:
                return expr[:q], expr[q + 1:i], expr[i + 1:]
            pending -= 1
    return None


def _c_to_py(expr: str) -> str:
    """a C++ integer expression of fused_attention.cu as Python: casts
    dropped, sizeof(float) 4, ``a ? b : c`` chains, parenthesised ones too"""
    expr = expr.replace("sizeof(float)", "4").replace("sizeof(bf16)", "2")
    expr = re.sub(r"(?<!/)/(?!/)", "//", re.sub(r"\((?:size_t|int|uint32_t)\)", "", expr))
    expr = " ".join(expr.split())
    while expr.startswith("(") and expr.endswith(")") and _balanced(expr[1:-1]):
        expr = expr[1:-1].strip()
    parts = _split_ternary(expr)
    if parts:
        cond, then, other = parts
        return f"({_c_to_py(then)} if {_c_to_py(cond)} else {_c_to_py(other)})"
    return f"({expr})"


def _balanced(expr: str) -> bool:
    depth = 0
    for ch in expr:
        depth += (ch == "(") - (ch == ")")
        if depth < 0:
            return False
    return depth == 0


def _function(src: str, name: str, args: str):
    """a one-expression constexpr function of the source as a Python lambda"""
    body = re.search(rf"constexpr \w+ {name}\({args}\) \{{\s*return ([^;]+);", src)[1]
    params = [a.split()[-1] for a in args.split(", ")]
    return lambda *vals: eval(_c_to_py(body), {**dict(zip(params, vals))})


def _layout(src: str, struct: str, args: str, env: dict, **vals) -> int:
    """the ``total`` of a layout struct's constexpr constructor"""
    body = re.search(rf"constexpr {struct}\({args}\) \{{(.*?)\n  \}}", src, re.S)[1]
    lay = dict(env, **vals)
    lay.update({name: 0 for name in re.findall(r"size_t ((?:\w+ = 0, )*\w+ = 0)", src)})
    for name, expr in re.findall(r"(\w+) = ([^;]+);", body):
        lay[name] = eval(_c_to_py(expr), lay)
    return lay["total"]


def _bounds(src: str, kernel: str, env: dict) -> tuple[int, int]:
    m = re.search(rf"__launch_bounds__\((.+?), (.+)\)\n{kernel}\(", src)
    return eval(_c_to_py(m[1]), env), eval(_c_to_py(m[2]), env)


def _source_plan(nt: int, d: int = D) -> dict:
    """the kernels' launch shape and shared memory at ``nt`` 64-row tiles
    and head dim ``d``, evaluated from fused_attention.cu's own expressions"""
    src = _cu()
    env: dict = {}
    for name in ("kAtRows", "kAtBox"):
        env[name] = eval(_c_to_py(re.search(rf"constexpr \w+ {name} = ([^;]+);", src)[1]), env)
    cg = eval(_c_to_py(re.search(r"static constexpr int kCG = ([^;]+);", src)[1]), {"D": d})
    env.update(nt=nt, NT=nt, D=d, kW=128, kAtMaxTiles=4, kTile=cg * env["kAtBox"],
               kWGroups=int(re.search(r"constexpr int kWGroups = (\d+);", src)[1]))
    env["kWTile"] = 2 * env["kAtBox"]
    env["bwd_warpgroups"] = _function(src, "bwd_warpgroups", "int nt")
    env["fwd_min_blocks"] = _function(src, "fwd_min_blocks", "int nt, int d")
    fwd = _function(src, "fwd_smem", "int nt, uint32_t tile")(nt, env["kTile"])
    out = {"fwd_smem": fwd}
    out["fwd_threads"], out["fwd_blocks"] = _bounds(src, "fused_attention_fwd_kernel", env)
    if d == 128:
        for part, rows in (("kv", nt * 64), ("q", env["kWGroups"] * 64)):
            out[f"bwd_{part}_threads"], out[f"bwd_{part}_blocks"] = _bounds(
                src, f"fused_attention_bwd_{part}_kernel", env)
            out[f"bwd_{part}_smem"] = _layout(src, "WideBwdSmem", "int nt, int lse_rows", env,
                                              nt=nt, lse_rows=rows, own=0)
        return out
    out["bwd_threads"], out["bwd_blocks"] = _bounds(src, "fused_attention_bwd_kernel", env)
    out["bwd_smem"] = _layout(src, "AttnBwdSmem", "int nt, int d", env, nt=nt, d=d, q=0)
    out["nw"] = env["bwd_warpgroups"](nt)
    return out


def plan(L: int, d: int = D) -> dict:
    """the Python mirror: one CTA per (head, batch row); the forward one
    warpgroup per 64-row tile at two CTAs an SM up to three tiles (at head
    dim 128 as many as shared memory holds); the backward one warpgroup per
    key tile (two passes of two at four tiles), one CTA an SM. Shared
    memory: the forward Q, K, V tiles; the backward Q, K, V, dO tiles, one
    pass's dS^T tiles, four f32 rows (lse, delta, 1/rms of q and k), the
    per-warp gamma partials; both an mbarrier slot and 1024 bytes to align
    the base. A tile is one 64 x 64 box (padded at head dim 32), two at 128.
    At head dim 128 the backward is two launches of two warpgroups a CTA,
    each owning a tile: the dK/dV one holds their K and V tiles, every Q and
    dO tile, lse and delta of every query row; the dQ one their Q and dO
    tiles, every K and V tile, lse and delta of their rows; each 1/rms of
    its 128 rows and eight warps' gamma partials"""
    nt = -(-L // TILE)
    nw = 2 if nt == 4 else nt
    box = TILE * 64 * 2
    tile = box * (2 if d == 128 else 1)
    out = {"fwd_threads": 128 * nt, "fwd_smem": 3 * nt * tile + 64 + 1024,
           "fwd_blocks": ({1: 4, 2: 3, 3: 2, 4: 1} if d < 128 else {1: 4, 2: 2, 3: 1, 4: 1})[nt]}
    if d == 128:
        for part, rows in (("kv", nt * TILE), ("q", 2 * TILE)):
            out[f"bwd_{part}_threads"], out[f"bwd_{part}_blocks"] = 256, 1
            out[f"bwd_{part}_smem"] = ((4 + 2 * nt) * tile + 2 * rows * 4 + 2 * TILE * 4
                                       + 8 * d * 4 + 64 + 1024)
        return out
    out.update(bwd_threads=128 * nw, bwd_blocks=1, nw=nw,
               bwd_smem=(4 + nw) * nt * box + 4 * nt * TILE * 4 + 2 * nw * 4 * d * 4 + 64 + 1024)
    return out


def _reg_cap(threads: int, blocks: int) -> int:
    """registers a thread under __launch_bounds__(threads, blocks): whole
    groups of 8, at most 255"""
    return min(255, SM_REGS // (threads * blocks) // 8 * 8)


@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_plan_mirrors_the_source(nt):
    """the Python plan is the source's, and the launch bounds leave the
    accumulators room: the forward's O (32 f32 a thread), a 32-key S half
    (16) and its packed P (8); the backward's S^T, dP^T, dK and dV (128),
    plus dQ (32 a query tile it owns) where two passes hold it across phase
    A; 16 registers spare for addresses and indices either way. Resident
    forward CTAs fit an SM's shared memory"""
    mine, src = plan(nt * TILE), _source_plan(nt)
    assert mine == src
    assert _reg_cap(mine["fwd_threads"], mine["fwd_blocks"]) >= 32 + 16 + 8 + 16
    nw = mine["nw"]
    held_dq = 32 * (nt // nw) if nt // nw > 1 else 0
    assert _reg_cap(mine["bwd_threads"], mine["bwd_blocks"]) >= 128 + held_dq + 16
    assert mine["fwd_blocks"] * (mine["fwd_smem"] + 1024) <= SM_SMEM


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_plan_mirrors_the_source_at_head_dims(nt, d):
    """the plan at head dims 32 (the D-64 layout, one zero-padded box a
    tile) and 128 (two boxes a tile; the two-launch backward): the source's,
    the forward's O (32 f32 a thread a box) beside its S half, P and 16
    spare; at 128 the dK/dV launch's dK, dV, S^T and dP^T (192) and the dQ
    launch's dQ, S and dP (128) with 16 spare under 255; resident forward
    CTAs fit an SM"""
    mine, src = plan(nt * TILE, d), _source_plan(nt, d)
    assert mine == src
    boxes = 2 if d == 128 else 1
    assert _reg_cap(mine["fwd_threads"], mine["fwd_blocks"]) >= 32 * boxes + 16 + 8 + 16
    assert mine["fwd_blocks"] * (mine["fwd_smem"] + 1024) <= SM_SMEM
    if d == 128:
        assert _reg_cap(mine["bwd_kv_threads"], mine["bwd_kv_blocks"]) >= 192 + 16
        assert _reg_cap(mine["bwd_q_threads"], mine["bwd_q_blocks"]) >= 128 + 16


def test_every_length_fits_shared_memory():
    """L 1..256 (``RESIDENT_LEN``, the resident kernels' whole range; longer
    windows take the streamed ones) fits a block's 232,448 bytes in both
    kernels, at every head dim"""
    assert fa.RESIDENT_LEN == 4 * TILE
    for d in (32, 64, 128):
        for L in range(1, fa.RESIDENT_LEN + 1):
            p = plan(L, d)
            assert all(v <= MAX_SMEM for k, v in p.items() if k.endswith("smem")), (L, d)
    assert plan(fa.RESIDENT_LEN)["bwd_smem"] == _source_plan(4)["bwd_smem"]
    assert plan(fa.RESIDENT_LEN, 128) == _source_plan(4, 128)


# ---- the residual rule and the JAX Pallas kernels themselves ----

@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference", "frozen"])
def test_residuals_only_when_a_gradient_will_be_taken(mode):
    """``needs_grad`` decides whether the forward kernel writes lse (the JAX
    ``_fwd_impl(save_residuals=...)`` rule): only with grad mode on and an
    input that requires grad"""
    qkv, qg, kg, _ = _inputs(1, 8, 2)
    qg = qg.clone().requires_grad_(mode != "frozen")
    ctx = {"no_grad": torch.no_grad(), "inference": torch.inference_mode()}.get(mode)
    if ctx is None:
        assert fa.needs_grad(qkv, qg, kg) == (mode == "grad")
    else:
        with ctx:
            assert not fa.needs_grad(qkv, qg, kg)


def test_port_matches_the_pallas_kernels_in_interpret_mode():
    """the port's plain forward and backward against the JAX Pallas kernels
    themselves (``fused_norm_rope_attention(..., interpret=True)`` and its
    ``jax.vjp``) at (B, L, H) = (1, 77, 2), numpy-seeded f32 inputs (1e-4:
    the Pallas kernels form the rotation and the head statistics as
    matrix products, and L = 77 is padded to 80 inside them)"""
    from osu_dreamer_tpu.ops.fused_attention import fused_norm_rope_attention as jfused

    rng = np.random.default_rng(77)
    qkv = 0.7 * rng.standard_normal((1, 77, 384), dtype=np.float32)
    qg, kg = (1 + 0.2 * rng.standard_normal(D, dtype=np.float32) for _ in range(2))
    go = rng.standard_normal((1, 77, 128), dtype=np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jfused(a, b, c, 2, True), qkv, qg, kg)
    out, lse = fa.fused_attention_fwd_plain(T(qkv), T(qg), T(kg), 2)
    np.testing.assert_allclose(N(out), np.asarray(want), atol=1e-4)
    grads = fa.fused_attention_bwd_plain(T(qkv), T(go), out, lse, T(qg), T(kg), 2)
    for name, g, w in zip(("dqkv", "dq_gamma", "dk_gamma"), grads, vjp(go)):
        np.testing.assert_allclose(N(g), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("d,H", [(128, 1), (32, 4)])
def test_port_matches_the_pallas_kernels_in_interpret_mode_at_head_dims(d, H):
    """as above at head dims 128 (one head) and 32 (four heads), L 77: the
    plain versions K9 and K10 are held to at every head dim the card takes"""
    from osu_dreamer_tpu.ops.fused_attention import fused_norm_rope_attention as jfused

    rng = np.random.default_rng(d)
    qkv = 0.7 * rng.standard_normal((1, 77, 3 * H * d), dtype=np.float32)
    qg, kg = (1 + 0.2 * rng.standard_normal(d, dtype=np.float32) for _ in range(2))
    go = rng.standard_normal((1, 77, H * d), dtype=np.float32)
    want, vjp = jax.vjp(lambda a, b, c: jfused(a, b, c, H, True), qkv, qg, kg)
    out, lse = fa.fused_attention_fwd_plain(T(qkv), T(qg), T(kg), H)
    np.testing.assert_allclose(N(out), np.asarray(want), atol=1e-4)
    grads = fa.fused_attention_bwd_plain(T(qkv), T(go), out, lse, T(qg), T(kg), H)
    for name, g, w in zip(("dqkv", "dq_gamma", "dk_gamma"), grads, vjp(go)):
        np.testing.assert_allclose(N(g), np.asarray(w), atol=1e-4, rtol=1e-4, err_msg=name)


# (B, L, H, D): the training length and the ragged edges of one and four
# tiles at head dims 32 and 128
HEAD_DIM_SHAPES = [(2, 152, 2, 32), (1, 65, 2, 32), (1, 1, 1, 32), (1, 256, 1, 32),
                   (2, 152, 1, 128), (1, 65, 1, 128), (1, 1, 1, 128), (1, 193, 1, 128)]


@pytest.mark.parametrize("B,L,H,d", HEAD_DIM_SHAPES)
def test_forward_emulation_holds_the_plain_rule_at_head_dims(B, L, H, d):
    """K9's order at head dims 32 and 128 under the D-64 rule"""
    qkv, qg, kg, _ = _inputs(B, L, H, seed=L + d, d=d)
    out, lse = fwd_emulation(qkv, qg, kg, H)
    want, want_lse = fa.fused_attention_fwd_plain(qkv, qg, kg, H)
    assert out.shape == want.shape == (B, L, H * d) and lse.shape == (B, H, L)
    assert (out.float() - want.float()).abs().max().item() <= _ulp_tol(want.float())
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=0)


@pytest.mark.parametrize("B,L,H,d", HEAD_DIM_SHAPES)
def test_backward_emulation_holds_grad_rel_at_head_dims(B, L, H, d):
    """K10's order at head dims 32 and 128 (there the two launches': dQ from
    dS formed again) under GRAD_REL"""
    qkv, qg, kg, go = _inputs(B, L, H, seed=2000 + L + d, d=d)
    out, lse = fwd_emulation(qkv, qg, kg, H)
    got = bwd_emulation(qkv, go, out, lse, qg, kg, H)
    ref = fa.fused_attention_bwd_plain(qkv.float(), go.float(), out, lse, qg, kg, H)
    for name, g, r in zip(("dqkv", "dq_gamma", "dk_gamma"), got, ref):
        g, r = g.float(), r.float()
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), name
        assert (g - r).abs().max().item() <= GRAD_REL * r.abs().max().item(), name



# ---- the streamed kernels (csrc/attention_stream.cu) ----

def stream_fwd_emulation(qkv: torch.Tensor, qg, kg, H: int):
    """K9 streamed: the prep pass's rotated rows (``norm_rope_emulation``,
    the resident kernels' rounding order), then the online-softmax forward
    of tests/test_torch_flash.py over zero-padded boxes -> (out, lse)"""
    from test_torch_flash import stream_flash_emulation

    B, L, _ = qkv.shape
    D = qkv.shape[-1] // (3 * H)
    rq, _ = norm_rope_emulation(_heads(qkv, H, 0, D), qg)
    rk, _ = norm_rope_emulation(_heads(qkv, H, 1, D), kg)
    q, k, v = (t.permute(0, 2, 1, 3).to(BF) for t in (rq, rk, _heads(qkv, H, 2, D)))
    return stream_flash_emulation(q, k, v, with_lse=True)


# (B, L, H, D): the head dims off the templated ones (12 padded to 16, 48
# and 96 in one and two boxes, 256 in four), the denoiser's 8 x 96 length
# L 320, and head dim 64 past the resident kernels' L 256
STREAM_SHAPES = [(2, 77, 2, 12), (1, 1, 2, 12), (1, 130, 2, 48), (1, 320, 2, 96),
                 (2, 65, 1, 96), (1, 193, 1, 256), (1, 257, 2, 64), (1, 512, 1, 64)]


def _jax_reference(qkv, qg, kg, go, H):
    """``rope_attention_reference`` and its ``jax.vjp`` in f32 on the same
    (bf16-valued) inputs -> (out, (dqkv, dq_gamma, dk_gamma))"""
    from osu_dreamer_tpu.ops.fused_attention import rope_attention_reference

    out, vjp = jax.vjp(lambda a, b, c: rope_attention_reference(a, b, c, H),
                       *(N(t.float()) for t in (qkv, qg, kg)))
    return np.asarray(out), [np.asarray(g) for g in vjp(N(go.float()))]


@pytest.mark.parametrize("B,L,H,d", STREAM_SHAPES)
def test_stream_forward_emulation_holds_the_jax_reference(B, L, H, d):
    """K9's streamed order: 4 ulp of ``rope_attention_plain`` (bf16), within
    GRAD_REL of the JAX ``rope_attention_reference`` in f32, and lse
    against the plain forward's"""
    qkv, qg, kg, go = _inputs(B, L, H, seed=3000 + L + d, d=d)
    out, lse = stream_fwd_emulation(qkv, qg, kg, H)
    want, want_lse = fa.fused_attention_fwd_plain(qkv, qg, kg, H)
    assert out.shape == want.shape == (B, L, H * d) and lse.shape == (B, H, L)
    assert (out.float() - want.float()).abs().max().item() <= _ulp_tol(want.float())
    torch.testing.assert_close(lse, want_lse, atol=2e-3, rtol=0)
    ref, _ = _jax_reference(qkv, qg, kg, go, H)
    assert np.abs(N(out.float()) - ref).max() <= GRAD_REL * np.abs(ref).max()


@pytest.mark.parametrize("B,L,H,d", STREAM_SHAPES)
def test_stream_backward_emulation_holds_the_jax_vjp(B, L, H, d):
    """K10's streamed order (the dK/dV and dQ launches over padded boxes,
    then the post pass) against ``jax.vjp`` of ``rope_attention_reference``
    in f32: every gradient within GRAD_REL of its largest magnitude"""
    qkv, qg, kg, go = _inputs(B, L, H, seed=4000 + L + d, d=d)
    out, lse = stream_fwd_emulation(qkv, qg, kg, H)
    got = bwd_emulation(qkv, go, out, lse, qg, kg, H, streamed=True)
    _, ref = _jax_reference(qkv, qg, kg, go, H)
    for name, g, r in zip(("dqkv", "dq_gamma", "dk_gamma"), got, ref):
        g = N(g.float())
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(g - r).max() <= GRAD_REL * np.abs(r).max(), name


def _stream_source() -> str:
    return (CSRC / "attention_stream.cu").read_text()


def test_stream_plan_fits_two_ctas_an_sm():
    """the wide streamed kernels' plan (head dims past 256) at every shape:
    a ring of four stages of three 8 KB boxes (+ barriers, + 1024 to
    align); two dQ CTAs of one consumer warpgroup and a producer warp an
    SM, by shared memory and by the launch bounds' register share; the
    dK/dV launch and the forward (one or two consumer warpgroups) one CTA an
    SM, for their registers"""
    src = _stream_source()
    consts = {}
    for name in ("kStRows", "kStMaxStages", "kStThreads", "kStChunk", "kStWideNB",
                 "kStWideStages"):
        consts[name] = eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src)[1].split("//")[0])
    assert consts == {"kStRows": 64, "kStMaxStages": 4, "kStThreads": 160,
                      "kStChunk": fa.POST_CHUNK, "kStWideNB": 3, "kStWideStages": 4}
    smem = consts["kStWideStages"] * 3 * 64 * 64 * 2 + 2 * consts["kStWideStages"] * 8 + 1024
    assert 2 * (smem + 1024) <= SM_SMEM
    bounds = re.findall(r"__launch_bounds__\(kStThreads, (\d)\)", src)
    assert bounds == ["1", "2"]
    assert "__launch_bounds__(NC == 1 ? kStThreads : (NC + 1) * 128, 1)" in src
    # the forward's three O boxes, S and P (at two consumer warpgroups the
    # 232 registers a consumer the producer warpgroup hands over); the
    # dK/dV launch's dK, dV, S^T, dP^T and the packed P^T, dS^T; the dQ
    # launch's dQ, S, dP and dS
    assert _reg_cap(consts["kStThreads"], 1) >= 3 * 32 + 32 + 16 + 16
    assert 40 * 128 + 232 * 256 <= _reg_cap(3 * 128, 1) * 3 * 128
    assert _reg_cap(consts["kStThreads"], 1) >= 4 * 32 + 2 * 16 + 16
    assert _reg_cap(consts["kStThreads"], 2) >= 3 * 32 + 16 + 16


def _stream_struct(src: str, name: str, nb: int, nc: int = 0) -> dict:
    """a plan struct of attention_stream.cu (``StFwd``, ``StKv``, ``StQ``)
    evaluated at NB = ``nb`` (and the forward's NC = ``nc``) from the
    source's own expressions"""
    env = {"NB": nb, "NC": nc, "st_min": min, "kMaxSmem": MAX_SMEM}
    for const in ("kStRows", "kStBox", "kStMaxStages", "kStTileCap"):
        expr = re.search(rf"constexpr \w+ {const} = ([^;]+);", src)[1]
        env[const] = eval(_c_to_py(expr.replace("sizeof(uint64_t)", "8")), env)
    for fn in ("held_copies", "ring_stages"):  # (held, stage, fixed) -> int
        expr = _c_to_py(re.search(rf"constexpr int {fn}\([^)]*\) {{\s*return ([^;]+);", src)[1])
        env[fn] = (lambda e: lambda held, stage, fixed: eval(
            e, {**env, "held": held, "stage": stage, "fixed": fixed}))(expr)
    body = re.search(rf"struct {name} {{(.*?)\n}};", src, re.S)[1]
    out = {}
    for key, expr in re.findall(r"static constexpr \w+ (\w+) = ([^;]+);", body):
        expr = expr.replace("sizeof(uint64_t)", "8").replace("&&", " and ")
        env[key] = out[key] = eval(_c_to_py(expr), env)
    return out


def stream_plan(kernel: str, nb: int, fwd_nc: int = 0) -> dict:
    """the Python mirror of the resident-width streamed kernels' plans at nb
    boxes a head (D <= 256): consumer warpgroups of 64 rows (the forward
    ``fwd_nc``: one, or three while O's registers allow (P through shared
    memory at three boxes), else two; the
    dK/dV launch two sharing a key tile; the dQ launch two to three boxes,
    else one) and a producer warpgroup; the held tiles (the forward's Q, the
    dK/dV launch's K and V, the dQ launch's Q and dO) in two copies where
    two ring stages still fit beside them (a persistent CTA loads the next
    work item's while this one runs), else one; the dK/dV launch's two f32
    exchange tiles; then as many stages (at most four) of two tiles as a
    block's shared memory holds, the barriers (each ring stage's full and
    empty ones, two of each for the held copies, and the exchange's) and
    1024 bytes to align the base"""
    box, cap = 64 * 64 * 2, MAX_SMEM - 1024 - 256
    tile = nb * box
    nc = {"fwd": fwd_nc, "kv": 2, "q": 2 if nb <= 3 else 1}[kernel]
    held = {"fwd": nc * tile, "kv": 2 * tile, "q": 2 * nc * tile}[kernel]
    # the dK/dV launch's two f32 exchange tiles; the forward's P tiles where
    # three warpgroups hold three boxes of O (P V's A operand from shared
    # memory, for the registers)
    fixed = {"kv": 2 * 32 * 128 * 4, "q": 0, "fwd": nc * box if nb == 3 and nc == 3 else 0}[kernel]
    hold = 2 if 2 * held + fixed + 2 * 2 * tile <= cap else 1
    stages = min(4, (cap - hold * held - fixed) // (2 * tile))
    bars = {"fwd": 4 * stages + 4, "kv": 2 * stages + 8, "q": 2 * stages + 4}[kernel]
    return {"nc": nc, "threads": (nc + 1) * 128, "stages": stages, "hold": hold,
            "smem": hold * held + fixed + stages * 2 * tile + 8 * bars + 1024}


@pytest.mark.parametrize("kernel", ["fwd", "kv", "q"])
@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_stream_resident_width_plan_mirrors_the_source(kernel, nb):
    """``stream_plan`` against the source's plan structs at each box count:
    one CTA an SM within a block's shared memory and at least two stages;
    the registers the producer warpgroup hands over (setmaxnreg) fill the
    launch's share exactly and cover each consumer's accumulators (the
    forward's O, S and P; the dK/dV launch's dK or dV, S^T or dP^T and its
    bf16 copy; the dQ launch's dQ, S, dP and dS) with 16 to spare"""
    src = _stream_source()
    name = {"fwd": "StFwd", "kv": "StKv", "q": "StQ"}[kernel]
    most = _function(src, "fwd_consumers", "int nb")(nb)
    assert most == (3 if nb <= 3 else 2)
    for fwd_nc in ((1, most) if kernel == "fwd" else (0,)):
        got = _stream_struct(src, name, nb, fwd_nc)
        want = stream_plan(kernel, nb, fwd_nc)
        assert got["kThreads"] == want["threads"] and got["kStages"] == want["stages"]
        assert got["kHold"] == want["hold"]
        assert got["kSmem"] == want["smem"] <= MAX_SMEM and want["stages"] >= 2
        nc = want["nc"]
        launch_regs = _reg_cap(want["threads"], 1)
        need = {"fwd": nb * 32 + 32 + 16, "kv": nb * 32 + 32 + 16,
                "q": nb * 32 + 64 + 16}[kernel]
        if nc == 1:  # no handover: every warpgroup keeps the launch's share
            producer = consumer = launch_regs
        elif kernel == "fwd":
            producer, consumer = got["kProducerRegs"], got["kConsumerRegs"]
        else:  # the backward's handover: 40 for the producer, 232 a consumer
            body = src[src.index(f"attention_stream_bwd_{kernel}_kernel("):]
            producer = int(re.search(r"setmaxnreg_dec<(\d+)>", body)[1])
            consumer = int(re.search(r"setmaxnreg_inc<(\d+)>", body)[1])
        assert producer * 128 + consumer * nc * 128 <= launch_regs * want["threads"]
        assert consumer >= launch_regs and consumer >= need + 16