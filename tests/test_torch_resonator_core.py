"""The resonator kernel's numerics (csrc/resonator.cu, K1), emulated on the
CPU in its own order, and its plan, before any card runs it.

``emulate`` follows the kernel step by step in f32: 128-frame chunks; per
chunk the (128, 98) @ (98, 144) contribution product; 4-frame segments scanned
from a zero state; the segment aggregates scanned over the 4 segments a
warp holds (lanes 8 apart: A^4, then A^8), the warps' aggregates folded by
a Horner in warp order (A^16), giving z, the chunk's states from a zero
state (z_i = y_i + A^(i+1) e for the segment's entering state e), and its
aggregate (z at its last frame); each complete group's 16 chunk aggregates
folded in order (A^128); and chunk c of group g entering with A^(128 p) H +
I, H the Horner over the aggregates of groups 0..g-1 (A^2048) and I over the
chunks 16 g..c-1 (A^128), its states z + A^(k+1) carry at frame k. The
powers are the module's f64-derived f32 tables. It is held to
the exact sequential IIR of the JAX package (``resonate_reference``, f64)
and to the Pallas kernel in interpret mode (``resonate_frames_pallas``).
"""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu.audio.constants import HOP_LEN, N_BINS, SR
from osu_dreamer_tpu.audio.spectrogram import resonate_reference
from osu_dreamer_tpu.ops.resonator import resonate_frames_pallas
from osu_dreamer_tpu_torch.ops import resonator as res

torch.set_num_threads(1)

CSRC = Path(res.__file__).parent.parent / "csrc"
MAX_SMEM = 232448   # a block's shared memory on an H100
SM_SMEM = 233472    # an SM's (228 KB), of which each resident block reserves 1 KB
SM_REGS = 65536
WARP_SEGS = 32 // res.BIN_GROUPS
# f32 against the f64 IIR and against the Pallas kernel (its own f32 scan):
# states are O(1) at these input scales, and 1e-5 is chip_smoke.py's kernel
# rule against the plain version
ATOL = 1e-5

# (S, K): one frame, the edges of one and two 128-frame chunks, a ragged few
# chunks, the last chunk of a group, a group aggregate in use, and two
SHAPES = [(1, 1), (3, 127), (3, 128), (3, 129), (2, 300), (1, 2047), (1, 2200), (1, 4500)]


# first rows of the power table's blocks (csrc/resonator.cu kPowFrame,
# kPowChunk, kPowGroup) and its row count (kPowRows): A^k for k <= CHUNK,
# A^(CHUNK p) for p < GROUP, A^(CHUNK GROUP)
POW_ROWS = {"frame": 0, "chunk": res.CHUNK + 1, "group": res.CHUNK + 1 + res.GROUP,
            "rows": res.CHUNK + 2 + res.GROUP}


def _pairs(t: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    t = torch.from_numpy(t)
    return t[..., 0], t[..., 1]


def cmad(a, b, c):
    """a b + c on (re, im) pairs of f32 tensors"""
    return a[0] * b[0] - a[1] * b[1] + c[0], a[0] * b[1] + a[1] * b[0] + c[1]


def carry_terms(c: int) -> tuple[list[int], list[int]]:
    """the aggregates chunk ``c`` folds, in their order: the groups before
    its own (group aggregates, Horner with A^(CHUNK GROUP)), then its group's
    chunks before it (chunk aggregates, Horner with A^CHUNK)"""
    g, p = divmod(c, res.GROUP)
    return list(range(g)), [g * res.GROUP + i for i in range(p)]


def emulate(frames: torch.Tensor, order: list[int] | None = None) -> torch.Tensor:
    """(S, K, HOP) f32 -> (S, K, F, 2) in the kernel's order; ``order`` is the
    sequence in which the (song, chunk) tickets are processed"""
    t = res._host_tables()
    W = torch.from_numpy(t["W"])
    pw = _pairs(t["pw"])
    rows = POW_ROWS
    P = lambda r: (pw[0][r], pw[1][r])  # noqa: E731  (F,) pair of power-table row r
    S, K, _ = frames.shape
    nch = -(-K // res.CHUNK)
    zero = (torch.zeros(N_BINS), torch.zeros(N_BINS))

    # phase 1 (per chunk, independent of every other): z and the aggregate
    local = {}
    for s in range(S):
        for c in range(nch):
            X = torch.zeros(res.CHUNK, HOP_LEN)
            k0 = c * res.CHUNK
            n = min(res.CHUNK, K - k0)
            X[:n] = frames[s, k0:k0 + n]
            C = (X @ W).view(res.SEGS, res.SEG_ROWS, 2 * N_BINS)
            cc = (C[..., :N_BINS], C[..., N_BINS:])
            y = [(cc[0][:, 0], cc[1][:, 0])]
            for i in range(1, res.SEG_ROWS):
                y.append(cmad(P(rows["frame"] + 1), y[-1], (cc[0][:, i], cc[1][:, i])))
            # inclusive scan over a warp's segments, d = 1, 2
            incl = [t_.view(-1, WARP_SEGS, N_BINS).clone() for t_ in y[-1]]
            d = 1
            while d < WARP_SEGS:
                prev = [t_[:, :-d].clone() for t_ in incl]
                upd = cmad(P(rows["frame"] + res.SEG_ROWS * d), prev,
                           (incl[0][:, d:], incl[1][:, d:]))
                incl[0][:, d:], incl[1][:, d:] = upd
                d *= 2
            excl = [torch.zeros_like(t_) for t_ in incl]
            excl[0][:, 1:], excl[1][:, 1:] = incl[0][:, :-1], incl[1][:, :-1]
            # Horner over the warps before each warp (A^(SEG_ROWS WARP_SEGS))
            nw = res.SEGS // WARP_SEGS
            cw = [zero]
            for w in range(1, nw):
                cw.append(cmad(P(rows["frame"] + res.SEG_ROWS * WARP_SEGS), cw[-1],
                               (incl[0][w - 1, -1], incl[1][w - 1, -1])))
            z = [[None] * res.SEGS for _ in range(res.SEG_ROWS)]
            for sg in range(res.SEGS):
                w, q = divmod(sg, WARP_SEGS)
                e = cmad(P(rows["frame"] + res.SEG_ROWS * q), cw[w], (excl[0][w, q], excl[1][w, q]))
                for i in range(res.SEG_ROWS):
                    z[i][sg] = cmad(P(rows["frame"] + i + 1), e, (y[i][0][sg], y[i][1][sg]))
            local[s, c] = (z, z[-1][-1])

    # phase 2: each complete group's aggregate, a Horner over its 16 chunk
    # aggregates (whichever chunk publishes last computes it)
    achunk, agroup = P(rows["chunk"] + 1), P(rows["group"])
    gagg = {}
    for s in range(S):
        for g in range(nch // res.GROUP):
            acc = zero
            for i in range(res.GROUP):
                acc = cmad(achunk, acc, local[s, g * res.GROUP + i][1])
            gagg[s, g] = acc

    # phase 3: every chunk's carry and states, in the given ticket order
    out = torch.zeros(S, K, N_BINS, 2)
    for ticket in order if order is not None else range(S * nch):
        s, c = divmod(ticket, nch)
        groups, chunks = carry_terms(c)
        H, I = zero, zero
        for j in chunks:
            I = cmad(achunk, I, local[s, j][1])
        for g in groups:
            H = cmad(agroup, H, gagg[s, g])
        carry = cmad(P(rows["chunk"] + c % res.GROUP), H, I)
        z = local[s, c][0]
        for sg in range(res.SEGS):
            for i in range(res.SEG_ROWS):
                r = sg * res.SEG_ROWS + i
                if c * res.CHUNK + r < K:
                    zi = cmad(P(rows["frame"] + r + 1), carry, z[i][sg])
                    out[s, c * res.CHUNK + r, :, 0], out[s, c * res.CHUNK + r, :, 1] = zi
    return out


def _waves(S: int, K: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((S, K * HOP_LEN))).astype(np.float32)


@pytest.mark.parametrize("S, K", SHAPES)
def test_emulation_matches_the_exact_iir(S, K):
    """every song against the f64 sequential IIR on its own wave (no state
    leaks between songs)"""
    waves = _waves(S, K)
    got = emulate(torch.from_numpy(waves.reshape(S, K, HOP_LEN))).numpy()
    for s in range(S):
        exact = resonate_reference(waves[s].astype(np.float64))
        np.testing.assert_allclose(got[s, ..., 0], exact.real, atol=ATOL)
        np.testing.assert_allclose(got[s, ..., 1], exact.imag, atol=ATOL)


@pytest.mark.parametrize("S, K", [(1, 1), (3, 129), (1, 2200)])
def test_emulation_matches_the_pallas_kernel(S, K):
    """the JAX Pallas kernel itself (interpret mode), song by song"""
    waves = _waves(S, K, seed=1)
    frames = waves.reshape(S, K, HOP_LEN)
    got = emulate(torch.from_numpy(frames)).numpy()
    for s in range(S):
        want = resonate_frames_pallas(jnp.asarray(frames[s]), HOP_LEN, N_BINS, SR, interpret=True)
        np.testing.assert_allclose(got[s], np.asarray(want), atol=ATOL)


def test_emulation_matches_the_plain_version():
    """the port's plain version (a doubling scan over the whole song), the
    kernel's yardstick on the card"""
    frames = torch.from_numpy(_waves(2, 2200, seed=2).reshape(2, 2200, HOP_LEN))
    torch.testing.assert_close(emulate(frames), res.resonate_plain(frames), atol=ATOL, rtol=0)


def test_carry_order_is_a_fixed_function_of_the_chunk():
    """a chunk's carry folds the same aggregates in the same order whatever
    order the tickets run in: two shuffled schedules give bit-identical states,
    and the terms depend on the chunk index alone"""
    frames = torch.from_numpy(_waves(2, 2200, seed=3).reshape(2, 2200, HOP_LEN))
    nch = -(-2200 // res.CHUNK)
    rng = np.random.default_rng(0)
    a = emulate(frames, rng.permutation(2 * nch).tolist())
    b = emulate(frames, rng.permutation(2 * nch).tolist())
    assert torch.equal(a, b)
    assert carry_terms(37) == ([0, 1], [32, 33, 34, 35, 36])
    assert carry_terms(15) == ([], list(range(15)))
    assert carry_terms(16) == ([0], [])


def test_power_table_rows():
    """the packed table's blocks and exponents (f64 powers rounded once to
    f32; 1e-6 relative leaves room for numpy's two integer-power paths)"""
    t = res._host_tables()
    rows = POW_ROWS
    assert t["pw"].shape == (rows["rows"], N_BINS, 2)
    from osu_dreamer_tpu_torch.audio.spectrogram import resonator_poles

    bH = resonator_poles()[1] ** HOP_LEN
    for row, e in ((rows["frame"], 0), (rows["frame"] + 5, 5), (rows["frame"] + 64, 64),
                   (rows["chunk"] + 3, 3 * res.CHUNK), (rows["group"], res.GROUP * res.CHUNK)):
        z = bH**e
        np.testing.assert_allclose(t["pw"][row, :, 0], z.real, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(t["pw"][row, :, 1], z.imag, rtol=1e-6, atol=1e-12)


def _source_constants() -> dict[str, int]:
    src = (CSRC / "resonator.cu").read_text()
    env: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        expr = re.sub(r"(\w+) > (\w+) \? (\w+) : (\w+)", r"max(\3, \4)", expr)
        env[name] = int(eval(expr.replace("/", "//"), {"max": max}, env))
    body = re.search(r"constexpr size_t kResSmem = ([^;]+);", src)[1]
    body = re.sub(r"\(size_t\)", "", body).replace("/", "//")
    env["kResSmem"] = eval(f"({body})", {}, env)
    bounds = re.search(r"__launch_bounds__\((\w+), (\w+)\)\nresonate_kernel", src)
    env["threads"], env["blocks"] = env[bounds[1]], env[bounds[2]]
    return env


def test_plan_mirrors_the_source():
    """the module's decomposition is the source's; the resident CTAs fit an
    SM's shared memory; the product's thread tile (8 frames x 9 columns) covers
    the chunk once; the registers leave room for its 72 accumulators, and
    in the scan for a thread's 4 x 9 complex states, its 9 inclusive and 9
    exclusive segment values, and the last chunk's 4 x 9 states it holds
    across the next product"""
    src = _source_constants()
    assert src["kSegRows"] == res.SEG_ROWS and src["kSegs"] == res.SEGS
    assert src["kChunk"] == res.CHUNK and src["kGroup"] == res.GROUP
    assert src["kBinGroups"] == res.BIN_GROUPS
    assert src["kPowRows"] == POW_ROWS["rows"]
    assert src["kBins"] == N_BINS and src["kHop"] == HOP_LEN
    assert src["threads"] == res.SEGS * res.BIN_GROUPS == 256
    assert src["kPRows"] * src["kPCols"] * src["threads"] == res.CHUNK * 2 * N_BINS
    smem = (HOP_LEN * 2 * N_BINS * 4 + res.CHUNK * max(HOP_LEN, src["kCsLd"]) * 4
            + src["kStaged"] * N_BINS * 8 + N_BINS * 8 + 16)
    # the staging holds a group's other chunks and the warps' aggregates
    assert src["kStaged"] >= res.GROUP and src["kStaged"] >= src["threads"] // 32
    assert src["kResSmem"] == smem <= MAX_SMEM
    assert src["blocks"] * (smem + 1024) <= SM_SMEM
    regs = min(255, SM_REGS // (src["threads"] * src["blocks"]))
    per = N_BINS // res.BIN_GROUPS
    held = 2 * res.SEG_ROWS * per
    assert regs >= held + src["kPRows"] * src["kPCols"] + src["kPRows"] + src["kPCols"] + 16
    assert regs >= 2 * held + 4 * per + 16
