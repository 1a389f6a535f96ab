"""The fused prologue forward's numerics and plan (csrc/film_qkv.cu, K11),
emulated on the CPU in its own order, before any card runs it.

``emulate`` walks the kernel's work items: flat rows over B L in tiles of
128 (64 past C 512), (row tile, 128-column group) items split into
ranges over the persistent CTAs (a tile's CTAs splitting its column groups
where CTAs outnumber tiles, else whole tiles and a slice of the leftover
tiles), y built once per tile a CTA meets; y from the ``fq_row`` chain (the f32 sum of squares in the kernel's
lane order and butterfly, 1/rms, each op rounded to bf16), then bf16(y W)
summed in f32, then + bias in bf16. It is held to ``film_qkv_plain`` and to
the Pallas ``_fwd_impl`` in interpret mode at ragged lengths under
chip_smoke.py's kernel rule (4 bf16 ulp of the output's largest magnitude:
the products are summed in other orders, and the Pallas kernel adds the
bias before its one rounding).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu.ops.film_qkv import _fwd_impl
from osu_dreamer_tpu_torch.ops import film_qkv as fq

torch.set_num_threads(1)

BF = torch.bfloat16
BF16_ULPS = 4
MAX_SMEM = 232448   # a block's shared memory on an H100
CSRC = Path(fq.__file__).parent.parent / "csrc"


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF).float()


def _inputs(B: int, L: int, C: int, F: int, seed: int = 0) -> list[torch.Tensor]:
    """x, scale, shift, add, kernel, bias in bf16 from a numpy seed"""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32)).to(BF)

    return [r(B, L, C), r(B, C, scale=0.3), r(B, C, scale=0.3), r(B, L, C, scale=0.5),
            r(C, F, scale=C**-0.5), r(F, scale=0.1)]


def row_inv(x: torch.Tensor) -> torch.Tensor:
    """1/rms of each row of x (n, C) as the kernels take it (``fq_row``'s
    order): lane l sums x^2 over its 8-column vectors l + 32 j in order, the
    lanes meet in a butterfly (16, 8, 4, 2, 1) -> (n, 1) f32"""
    n, C = x.shape
    sq = (x.float() ** 2).numpy().reshape(n, C // 8, 8)
    lanes = np.zeros((n, 32), dtype=np.float32)
    for v in range(C // 8):
        for q in range(8):
            lanes[:, v % 32] += sq[:, v, q]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    return torch.rsqrt(torch.from_numpy(lanes[:, :1]) / C + 1e-6)


def build_y(x, add, sc, sh):
    """rows of y as the kernel builds them: ``row_inv``, then the bf16 chain"""
    inv = row_inv(x)
    y = _bf(_bf(x.float() * inv) * _bf(1 + sc.float()))
    return _bf(_bf(y + sh.float()) + add.float())


def emulate(x, scale, shift, add, kernel, bias, sms: int = 132):
    """-> (out (B, L, F) bf16, [(cta, tile) for every y build])"""
    B, L, C = x.shape
    F = kernel.shape[1]
    plan = fq.fwd_plan(B, L, C, F, sms)
    rows, ngrp, items, ctas = plan["rows"], F // fq.FWD_COLS, plan["items"], plan["ctas"]
    BL = B * L
    xr, ar = x.reshape(BL, C), add.reshape(BL, C)
    batch = torch.arange(BL) // L
    out = torch.full((BL, F), float("nan"), dtype=BF)
    builds = []
    for cta, items_of in enumerate(fq.fwd_items(plan["tiles"], ngrp, ctas)):
        prev, y = None, None
        for item in items_of:
            tile, grp = divmod(item, ngrp)
            r = slice(tile * rows, min(BL, (tile + 1) * rows))
            if tile != prev:
                b = batch[r]
                y = build_y(xr[r], ar[r], scale[b], shift[b])
                builds.append((cta, tile))
                prev = tile
            cols = slice(grp * fq.FWD_COLS, (grp + 1) * fq.FWD_COLS)
            acc = y @ kernel[:, cols].float()
            out[r, cols] = (_bf(acc) + bias[cols].float()).to(BF)
    return out.reshape(B, L, F), builds


def _rule(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.float(), want.float()
    tol = BF16_ULPS * 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol


# (B, L, C, F, sms): one row, the edges of one and two 64-row and 128-row
# tiles, batch rows meeting inside a tile, one warpgroup past C 512; few CTAs,
# so that a tile's CTAs split its column groups, or (fewer CTAs than tiles)
# a CTA's range spans tiles
SHAPES = [(1, 1, 128, 256, 3), (2, 63, 128, 256, 3), (2, 64, 128, 256, 5), (3, 65, 192, 128, 4),
          (2, 129, 128, 256, 7), (2, 65, 640, 256, 5), (2, 200, 128, 256, 3)]


@pytest.mark.parametrize("B, L, C, F, sms", SHAPES)
def test_emulation_holds_the_plain_rule(B, L, C, F, sms):
    args = _inputs(B, L, C, F, seed=L)
    got, builds = emulate(*args, sms=sms)
    _rule(got, fq.film_qkv_plain(*args))
    # every item once, y once per tile a CTA meets
    assert len(set(builds)) == len(builds)
    assert {t for _, t in builds} == set(range(fq.fwd_plan(B, L, C, F, sms)["tiles"]))


@pytest.mark.parametrize("L", [63, 129])
def test_emulation_holds_the_pallas_forward(L):
    """the Pallas kernel K11 replaces (interpret mode, bf16, a ragged tile)"""
    args = _inputs(2, L, 128, 256, seed=7)
    want = _fwd_impl(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in args),
                     tile=64, interpret=True)
    got, _ = emulate(*args, sms=4)
    _rule(got, torch.from_numpy(np.array(want.astype(jnp.float32))))


def _source_layout(C: int, nwg: int, stages: int) -> int:
    """FqfLayout(C, nwg, stages).total from csrc/film_qkv.cu"""
    src = (CSRC / "film_qkv.cu").read_text()
    env = {name: int(eval(expr.replace("/", "//"), {}, {}))
           for name, expr in re.findall(r"constexpr (?:int|uint32_t) (kFqf\w+) = ([\d *]+);", src)}
    env["kFqfStage"] = 2 * env["kFqfTile"]
    env.update(C=C, nwg=nwg, stages=stages)
    body = re.search(r"FqfLayout\(int C, int nwg, int stages\) \{(.*?)\n  \}", src, re.S)[1]
    for name, expr in re.findall(r"(\w+) = ([^;]+);", body):
        expr = re.sub(r"\(size_t\)", "", expr).replace("sizeof(float)", "4")
        expr = expr.replace("sizeof(uint64_t)", "8").replace("/", "//")
        env[name] = eval(expr, {}, env)
    assert env["kFqfCols"] == fq.FWD_COLS
    return env["total"]


@pytest.mark.parametrize("C", [384, 512, 640, 1024])
def test_plan_mirrors_the_source(C):
    """the module's plan has the source's shared-memory arithmetic, fits a
    block's 232,448 bytes with a ring of at least 4 stages, and fills the
    card at the main path's two shapes"""
    for B, L in ((4, 759), (128, 152)):
        p = fq.fwd_plan(B, L, C, 3072)
        assert p["smem"] == _source_layout(C, p["warpgroups"], p["stages"]) <= MAX_SMEM
        assert _source_layout(C, p["warpgroups"], p["stages"] + 1) > MAX_SMEM or p["stages"] == 8
        assert p["stages"] >= 4
        assert p["rows"] == (128 if C <= 512 else 64)
        assert p["tiles"] == -(-(B * L) // p["rows"]) and p["items"] == p["tiles"] * 24
        assert p["ctas"] == 132


def test_work_items_at_the_main_shapes():
    """B4 L759 C512 (a request's prologue): 24 tiles of 128 rows x 24 column
    groups = 576 items, 4 or 5 a CTA, each CTA inside one tile (one y
    build); B128 L152 (training): 152 tiles, 3648 items, 27 or 28 a CTA (one
    whole tile and a slice of one of the 20 left over: two builds). Every
    item is taken exactly once."""
    for B, L, tiles, span, most in ((4, 759, 24, 1, 5), (128, 152, 152, 2, 28)):
        p = fq.fwd_plan(B, L, 512, 3072)
        assert (p["tiles"], p["items"], p["ctas"]) == (tiles, tiles * 24, 132)
        walks = fq.fwd_items(tiles, 24, 132)
        assert sorted(i for w in walks for i in w) == list(range(p["items"]))
        assert max(len({i // 24 for i in w}) for w in walks) == span
        assert max(len(w) for w in walks) == most


def ring_walk(items: list[int], kt: int, nst: int, ahead: int | None = None) -> bool:
    """the forward kernel's producer and consumers over one CTA's items (row
    tile of each), stepped until both finish or neither can move -> finished.
    The producer takes a ring stage per add box and W step (waiting for the
    consumers to release the stage taken ``nst`` earlier); at a new tile it
    issues the first min(kt, nst) add boxes, waits until the consumers are
    done with the last tile's y, then issues x and the remaining boxes. The
    consumers wait for x before any add box, release each stage after use,
    and free y after the last item of a tile. ``ahead`` overrides the number
    of add boxes issued before x."""
    prod, cons = [], []  # ("stage", kind) / ("yfree", n) / ("x", n) events
    tiles = 0
    for i, tile in enumerate(items):
        if i == 0 or tile != items[i - 1]:
            pre = min(kt, nst) if ahead is None else ahead
            prod += [("stage", "add")] * pre
            if tiles:
                prod.append(("yfree", tiles))
            prod.append(("x", tiles + 1))
            prod += [("stage", "add")] * (kt - pre)
            cons.append(("x", tiles + 1))
            cons += [("use", "add")] * kt
            tiles += 1
        prod += [("stage", "w")] * kt
        cons += [("use", "w")] * kt
        if i + 1 == len(items) or items[i + 1] != tile:
            cons.append(("yfree", tiles))
    p = c = issued = released = x_done = y_freed = 0
    while p < len(prod) or c < len(cons):
        moved = False
        if p < len(prod):
            kind, n = prod[p]
            if kind == "stage" and issued - released < nst:
                issued, p, moved = issued + 1, p + 1, True
            elif kind == "yfree" and y_freed >= n:
                p, moved = p + 1, True
            elif kind == "x":
                x_done, p, moved = n, p + 1, True
        if c < len(cons):
            kind, n = cons[c]
            if kind == "x" and x_done >= n:
                c, moved = c + 1, True
            elif kind == "use" and released < issued:
                released, c, moved = released + 1, c + 1, True
            elif kind == "yfree":
                y_freed, c, moved = n, c + 1, True
        if not moved:
            return False
    return True


@pytest.mark.parametrize("C", [64, 384, 512, 640, 1024])
def test_ring_protocol_finishes(C):
    """no stage, x or y wait can block forever: at every width's ring depth
    (fewer stages than add boxes at C 512 and 1024), for a CTA meeting one
    tile, two tiles, or a new tile at every item"""
    p = fq.fwd_plan(4, 759, C, 3072)
    kt, nst = C // 64, p["stages"]
    for items in ([0] * 5, [0, 0, 1, 1, 1], [0, 1, 2, 3]):
        assert ring_walk(items, kt, nst), (C, items)
    # issuing every add box before x stalls where the ring is shallower than
    # a tile's boxes
    assert ring_walk([0, 1], kt, nst, ahead=kt) == (kt <= nst)
