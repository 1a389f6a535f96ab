"""The fused prologue backward (csrc/film_qkv.cu, K12), emulated on the CPU
in its own order, and its plan, before any card runs it.

``emulate`` follows the kernels: the y pass (y and 1/rms in ``fq_row``'s
order, as K11 builds them), then each persistent cluster's 128-row tiles
(rows flat over B L), each CTA of the cluster its 64-column boxes of dy:
dy = g W^T summed over F in 64-column chunks in f32 from the bf16 g and W;
dadd = bf16(dy); each CTA's partial row sums of dxn x over its own columns,
added in rank order into the one mean every CTA uses; dx; the film sums
split at the batch-row boundaries into one partial per (consumer warp of 16
rows, batch row of its rows); db over half tiles; then the fixed-order sums
(each batch row's partials in warp order; db's half tiles in eight runs, each in
order, then the runs in order) and dW = y^T g in f32. It is held to ``film_qkv_bwd_plain`` in f32 and to the Pallas
``_bwd_impl`` in interpret mode, at L 1, 63, 64, 65, 77 and 152 (tiles that
straddle batch rows) and C 384, 512, 640 and 1024.

Tolerances, against the plain version in f32 on the same (bf16-valued)
inputs: dx and dadd within one bf16 ulp of their largest magnitude (the
emulation rounds its f32 results once to bf16, the plain version does not
round); dscale, dshift and dbias within 1e-5 of theirs (f32 sums of the
same f32 terms in another order); dkernel within 2^-7 of its largest
magnitude (its y is the bf16 forward's, the plain f32 version's is not
rounded). Against the Pallas kernel, which rounds dx and dadd to bf16
too: the same, except dx and dadd within two ulp (both round an f32 value
summed in another order); its y, computed by XLA, may skip the bf16
roundings between ops that the port's y takes, so dkernel stays at 2^-7.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu.ops.film_qkv import _bwd_impl
from osu_dreamer_tpu_torch.ops import film_qkv as fq
from test_torch_film_qkv_core import _bf, _inputs, build_y, row_inv

torch.set_num_threads(1)

BF = torch.bfloat16
MAX_SMEM = 232448   # a block's shared memory on an H100
CSRC = Path(fq.__file__).parent.parent / "csrc"
GRADS = ("dx", "dscale", "dshift", "dadd", "dkernel", "dbias")


def _grad_out(B: int, L: int, F: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed + 100)
    return torch.from_numpy(rng.standard_normal((B, L, F), dtype=np.float32)).to(BF)


def emulate(x, scale, shift, add, kernel, g, held: int | None = None):
    """-> (the six gradients in the order of ``film_qkv_bwd_plain``,
    {(warp, slot): batch rows summed into that film partial})"""
    B, L, C = x.shape
    F = kernel.shape[1]
    BL, R = B * L, fq.BWD_ROWS
    plan = fq.bwd_plan(B, L, C, F, held)
    n, nb, S, tiles = plan["cluster"], plan["boxes"], plan["segments"], plan["tiles"]
    xr, ar, gr = x.reshape(BL, C).float(), add.reshape(BL, C), g.reshape(BL, F).float()
    W = kernel.float()
    batch = torch.arange(BL) // L
    # the y pass
    y = build_y(x.reshape(BL, C), ar, scale[batch], shift[batch])
    inv = row_inv(x.reshape(BL, C))
    one_sc = 1 + scale.float()[batch]

    dx = torch.full((BL, C), float("nan"))
    dadd = torch.full((BL, C), float("nan"))
    part_film = torch.full((8 * tiles, S, 2 * C), float("nan"))
    part_db = torch.full((2 * tiles, F), float("nan"))
    members: dict[tuple[int, int], set[int]] = {}
    for walk in fq.bwd_tiles(tiles, plan["clusters"]):
        for t in walk:
            r = slice(t * R, min(BL, (t + 1) * R))
            rows = r.stop - r.start
            gt = torch.zeros(R, F)
            gt[:rows] = gr[r]  # the TMA fills rows past B L with zeros
            for h in range(2):  # db: the producer's two warps, half a tile each
                part_db[2 * t + h] = gt[64 * h : 64 * h + 64].sum(0)
            dys, partial = [], []
            for rank in range(n):
                cols = slice(rank * nb * 64, min(C, (rank + 1) * nb * 64))
                dy = torch.zeros(R, cols.stop - cols.start)
                for ks in range(F // 64):
                    f = slice(64 * ks, 64 * ks + 64)
                    dy += gt[:, f] @ W[cols, f].T
                dy = dy[:rows]
                dys.append((cols, dy))
                partial.append((dy * one_sc[r, cols] * xr[r, cols]).sum(-1))
            m = sum(partial) / C  # the exchanged partials, in rank order
            for cols, dy in dys:
                dxn = dy * one_sc[r, cols]
                dadd[r, cols] = _bf(dy)
                dx[r, cols] = _bf(inv[r] * dxn - inv[r] ** 3 * xr[r, cols] * m[:, None])
                xn = xr[r, cols] * inv[r]
                # one film partial per (consumer warp, batch row of its 16 rows)
                for w in range(8 * t, 8 * t + 8):
                    wr = slice(16 * w - r.start, min(rows, 16 * w + 16 - r.start))
                    if wr.start >= rows:
                        continue
                    wbatch = batch[r][wr]
                    for b in range(16 * w // L, int(wbatch[-1]) + 1):
                        mask = wbatch == b
                        k = (w, b - 16 * w // L)
                        part_film[k[0], k[1], cols] = (dy[wr] * xn[wr])[mask].sum(0)
                        part_film[k[0], k[1], C + cols.start : C + cols.stop] = dy[wr][mask].sum(0)
                        members.setdefault(k, set()).update(wbatch[mask].tolist())
    assert not dx.isnan().any() and not dadd.isnan().any()
    # fq_film_reduce_kernel: each batch row's partials in warp order
    film = torch.zeros(B, 2 * C)
    for b in range(B):
        for w in range(b * L // 16, ((b + 1) * L - 1) // 16 + 1):
            film[b] += part_film[w, b - 16 * w // L]
    assert not film.isnan().any()
    db = torch.zeros(F)
    T = 2 * tiles
    for k in range(8):  # fq_reduce_kernel: eight runs of half tiles, each in order
        run = torch.zeros(F)
        for t in range(k * T // 8, (k + 1) * T // 8):
            run += part_db[t]
        db += run
    dw = y.float().T @ gr
    return (dx.reshape(B, L, C), film[:, :C], film[:, C:], dadd.reshape(B, L, C), dw, db), members


def _ulp(want: torch.Tensor) -> float:
    return 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)


def _hold(got, want, dkernel_rel: float, bf16_ulps: int) -> None:
    for name, a, b in zip(GRADS, got, want):
        a, b = a.float(), b.float()
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        if name in ("dx", "dadd"):
            tol = bf16_ulps * _ulp(b)
        else:
            tol = (dkernel_rel if name == "dkernel" else 1e-5) * b.abs().max().item()
        assert err <= tol, f"{name}: max abs err {err:.4g} > {tol:.4g}"


# (B, L, C, F, held): one row a batch row (a tile holds all three), the
# edges of a 64-row and a 128-row tile, batch rows meeting inside tiles, the
# ragged L 77 and the training L 152; every cluster width (two CTAs at C 384
# and 512, three at C 640 with the last one's fourth box past C, four at C
# 1024); few clusters, so that a cluster walks several tiles
SHAPES = [(3, 1, 512, 256, None), (3, 63, 384, 256, 1), (3, 64, 512, 128, 2),
          (3, 65, 640, 256, 1), (2, 77, 1024, 128, 1), (4, 152, 512, 256, 2),
          (3, 152, 384, 128, 3), (5, 65, 1024, 128, 2), (2, 129, 640, 128, None)]


@pytest.mark.parametrize("B, L, C, F, held", SHAPES)
def test_emulation_holds_the_plain_version(B, L, C, F, held):
    args = _inputs(B, L, C, F, seed=C + L)
    g = _grad_out(B, L, F, C + L)
    got, members = emulate(*args[:5], g, held)
    _hold(got, fq.film_qkv_bwd_plain(*(t.float() for t in args), g.float()), 2.0**-7, 1)
    # no film partial mixes batch rows
    assert all(len(rows) == 1 for rows in members.values())


@pytest.mark.parametrize("B, L", [(2, 63), (3, 152)])
def test_emulation_holds_the_pallas_backward(B, L):
    """the Pallas kernel K12 replaces (interpret mode, bf16, ragged tiles)"""
    C, F = 128, 128
    args = _inputs(B, L, C, F, seed=L + 5)
    g = _grad_out(B, L, F, L + 5)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    want = _bwd_impl(*(j(t) for t in args[:5]), j(g), tile=64, interpret=True)
    dx, dadd, dsc, dsh, dw, db = (torch.from_numpy(np.array(w.astype(jnp.float32))) for w in want)
    got, _ = emulate(*args[:5], g, held=1)
    _hold(got, (dx, dsc, dsh, dadd, dw, db), 2.0**-7, 2)


@pytest.mark.parametrize("L", [1, 2, 8, 15, 16, 17, 63, 64, 65, 77, 129, 152])
def test_film_partials_never_mix_batch_rows(L):
    """the plan's (warp, slot) partials (a consumer warp holds 16 flat rows):
    every row lands in the slot of its batch row, slots stay below
    ``segments``, and each batch row's partials are exactly those its rows
    reach, in warp order, as fq_film_reduce_kernel reads them"""
    B = 7
    plan = fq.bwd_plan(B, L, 512, 3072)
    BL = B * L
    slots: dict[tuple[int, int], set[int]] = {}
    for w in range(8 * plan["tiles"]):
        for row in range(16 * w, min(BL, 16 * w + 16)):
            slot = row // L - 16 * w // L
            assert 0 <= slot < plan["segments"]
            slots.setdefault((w, slot), set()).add(row // L)
    assert all(len(b) == 1 for b in slots.values())
    for b in range(B):
        reads = [(w, b - 16 * w // L) for w in range(b * L // 16, ((b + 1) * L - 1) // 16 + 1)]
        assert reads == sorted(k for k, v in slots.items() if b in v)
    assert plan["segments"] == max(len({r // L for r in range(s, s + 16)}) for s in range(L + 1))


def _source_env() -> dict:
    """the backward's constants and plan functions from csrc/film_qkv.cu"""
    src = (CSRC / "film_qkv.cu").read_text()
    env = {name: int(eval(expr, {}, {}))
           for name, expr in re.findall(r"constexpr (?:int|uint32_t) (kFqb\w+) = ([\d *]+);", src)}
    env["kMaxSmem"] = int(re.search(r"kMaxSmem = (\d+);",
                                    (CSRC / "common.cuh").read_text())[1])
    for fn in ("fqb_cluster", "fqb_boxes", "fqb_segments"):
        arg, body = re.search(rf"inline int {fn}\(int (\w)\) \{{ return ([^;]+); \}}", src).groups()
        env[fn] = eval(f"lambda {arg}: " + body.replace("/", "//"), dict(env))
    body = re.search(r"FqbLayout\(int nb, int stages\) \{(.*?)\n  \}", src, re.S)[1]

    def layout(nb: int, stages: int) -> dict:
        loc = dict(env, nb=nb, stages=stages)
        for name, expr in re.findall(r"(\w+) = ([^;]+);", body):
            expr = re.sub(r"\(size_t\)", "", expr).replace("sizeof(float)", "4")
            expr = expr.replace("sizeof(uint64_t)", "8").replace("/", "//")
            loc[name] = eval(expr, {}, loc)
        return loc

    env["layout"] = layout
    return env


@pytest.mark.parametrize("C", [64, 128, 256, 384, 512, 640, 768, 1024])
def test_plan_mirrors_the_source(C):
    """``bwd_plan`` has the source's cluster, boxes, segments and
    shared-memory arithmetic; a CTA's dy fits 128 registers a thread
    (four 64-column boxes), the cluster covers C in at most four CTAs
    (portable), the ring holds at least four stages and fits a block's
    232,448 bytes"""
    env = _source_env()
    assert env["kFqbRows"] == fq.BWD_ROWS
    n, nb = env["fqb_cluster"](C), env["fqb_boxes"](C)
    p = fq.bwd_plan(128, 152, C, 3072)
    assert (p["cluster"], p["boxes"]) == (n, nb)
    assert n <= env["kFqbMaxCluster"] and nb <= env["kFqbMaxBoxes"]
    assert nb * 64 * 64 // 128 <= 128 and (n - 1) * nb * 64 < C <= n * nb * 64
    fixed = env["layout"](nb, 0)["total"]
    stages = min(env["kFqbMaxStages"], (env["kMaxSmem"] - fixed) // env["layout"](nb, 0)["stage"])
    assert p["stages"] == stages >= 4
    assert p["smem"] == env["layout"](nb, stages)["total"] <= MAX_SMEM
    assert p["tiles"] == 152 and p["ctas"] == p["clusters"] * n <= 132
    for L in (1, 2, 63, 64, 77, 128, 152, 759):
        assert fq.bwd_plan(4, L, C, 3072)["segments"] == env["fqb_segments"](L)


def _c_expr(expr: str, env: dict) -> int:
    """a C integer expression of the kernel (one ``a ? b : c``, ``/``)"""
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr.strip())
    if m:
        expr = f"({m[2]}) if ({m[1]}) else ({m[3]})"
    return eval(expr.replace("/", "//"), {}, env)


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
def test_x_stages_hold_the_scale_boxes(nb):
    """after a tile's products its x boxes (16 KB each) and the scale rows
    of its first kFqbScaleRows batch rows (a 1 KB box each) ride kE ring
    stages, parsed from the kernel: the scale boxes sit 1024-aligned after
    the last x box inside that stage, and while the consumers hold the x
    stages the ring keeps at least two for the next tile's g and W"""
    env = _source_env()
    src = (CSRC / "film_qkv.cu").read_text()
    m = re.search(r"constexpr int kXper = ([^,]+), kE = ([^;]+);", src)
    loc = dict(env, NB=nb)
    loc["kXper"] = _c_expr(m[1], loc)
    loc["kE"] = _c_expr(m[2], loc)
    soff = _c_expr(re.search(r"constexpr int kSOff = ([^;]+);", src)[1], loc)
    stage = env["layout"](nb, 0)["stage"]
    tile, kxper, ke = env["kFqbTile"], loc["kXper"], loc["kE"]
    assert kxper * 2 * tile <= stage and ke * kxper >= nb > (ke - 1) * kxper
    assert soff % 1024 == 0 and soff + nb * env["kFqbScaleRows"] * 128 <= stage
    plan = fq.bwd_plan(4, 152, 64 * nb, 3072)
    assert plan["boxes"] == nb and plan["stages"] >= ke + 2


def test_each_tile_once():
    """the persistent clusters take every tile once, in order: at B128 L152
    C512, 152 tiles over 66 two-CTA clusters, three at most"""
    p = fq.bwd_plan(128, 152, 512, 3072)
    assert (p["tiles"], p["clusters"], p["cluster"]) == (152, 66, 2)
    walks = fq.bwd_tiles(p["tiles"], p["clusters"])
    assert sorted(t for w in walks for t in w) == list(range(152))
    assert max(len(w) for w in walks) == 3 and all(w == sorted(w) for w in walks)
