"""Training past the JAX fused-attention gate, on the CPU in f32 against the
JAX package:

- the gradients of the port's ``long_flash_attention`` (ops/long_attention.py:
  on CPU tensors autograd of ``attention_plain``, the plain version of the
  card's streamed forward and long attention backward) against the JAX
  ``long_flash_attention`` VJP (the Pallas forward in interpret mode; its
  backward is the vjp of ``_xla_reference``) at head dims 8, 12, 64 and 96
  and L 1, 65 and 300: within 1e-5 of the largest gradient magnitude (f32 on
  both sides; the sums differ only in their order);
- one training step of the narrow denoiser at the shipped 16 x 64 heads and
  L 300 (L H D 307,200, past the gate) against the JAX step on transplanted
  parameters (the tolerances of tests/test_torch_head_dims.py);
- the route of that shape and ``fit.run``'s want of any refusal there;
- the card's one-pass backward (csrc/long_attention_bwd.cu, padded head dims
  up to 128) emulated in its tile order (``bwd_emulation``): per 128-key
  block, each 64-key half and 64-row query tile S^T and dP^T, P^T =
  exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale each rounded to
  bf16 once, dV += P^T dO and dK += dS^T Q in f32; a query tile's dQ part
  of the block (at head dims to 64 the halves' dS K summed, past 64 dS K
  over the 128 keys in one product) added to its accumulator in key-block
  order, dQ rounded to bf16 at the end. It is held under
  GRAD_REL (every gradient's max abs error within 3 % of its largest
  magnitude) to f32 autograd of ``attention_plain`` and to the JAX VJP;
- that kernel's shared-memory and register plan, read from its source.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

GRAD_REL = 0.03
TILE = 64
MAX_SMEM = 232448  # a block's shared memory on an H100 (227 KB)
SM_REGS = 65536


@pytest.mark.parametrize("L", [1, 65, 300])
@pytest.mark.parametrize("D", [8, 12, 64, 96])
def test_long_attention_gradients_match_the_jax_vjp(D, L):
    import jax
    import jax.numpy as jnp

    from osu_dreamer_tpu.ops.long_attention import long_flash_attention as jax_attention
    from osu_dreamer_tpu_torch.ops.long_attention import attention_bwd_plain, long_flash_attention

    B, H = 2, 2
    rng = np.random.default_rng(D * 1000 + L)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    grad = rng.standard_normal((B, L, H * D)).astype(np.float32)
    want_out, pullback = jax.vjp(lambda a, b, c: jax_attention(a, b, c, True),
                                 *map(jnp.asarray, (q, k, v)))
    want = pullback(jnp.asarray(grad))

    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = long_flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(grad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5)
    plain = attention_bwd_plain(*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(grad))
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        w = np.asarray(w)
        assert g.shape == (B, L, H, D)
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=name)
    if L == 1:  # one key: the softmax is 1 whatever the logits, so dq and dk vanish
        assert not got[0].any() and not got[1].any()


def test_denoiser_trains_at_16_by_64_heads_past_the_gate():
    """the shipped 16 x 64 heads at L 300 route to the long attention, and
    one f32 step of the narrow denoiser there (loss terms and every gradient
    leaf) equals the JAX step"""
    from osu_dreamer_tpu_torch.models.diffusion import fit
    from osu_dreamer_tpu_torch.ops.fused_attention import attention_route
    from test_torch_head_dims import train_step_against_jax

    assert attention_route(300, 16, 64) == "long"
    assert not hasattr(fit, "check_attention_shape")
    train_step_against_jax(16, 64, 300)


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _inputs(B: int, L: int, H: int, D: int, seed: int):
    """bf16-valued q, k, v (B, L, H, D) and output gradient (B, L, H D) in
    f32, from a numpy seed"""
    rng = np.random.default_rng(seed)
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal((B, L, H, D), dtype=np.float32)))
               for _ in range(3))
    go = _bf(torch.from_numpy(rng.standard_normal((B, L, H * D), dtype=np.float32)))
    return q, k, v, go


def bwd_emulation(q, k, v, out, lse, go):
    """csrc/long_attention_bwd.cu's order: q, k, v (B, L, H, D), out and go
    (B, L, H D) bf16 values, lse (B, H, L) f32 -> (dq, dk, dv) (B, L, H, D)
    bf16 values"""
    B, L, H, D = q.shape
    scale = D**-0.5
    ds_scale = scale if L > 1 else 0.0  # a softmax over one key: exactly 0
    nq, nkb = -(-L // TILE), -(-L // (2 * TILE))
    Lp = nkb * 2 * TILE

    def rows(x):  # (B, L, H, D) -> (B, H, Lp, D), zero past L
        return F.pad(x.permute(0, 2, 1, 3), (0, 0, 0, Lp - L))

    qh, kh, vh = rows(q), rows(k), rows(v)
    goh, oh = (rows(t.reshape(B, L, H, D)) for t in (go, out))
    delta = (goh * oh).sum(-1)  # rowsum(dO O) in f32, 0 past L
    lsep = F.pad(lse, (0, Lp - L), value=float("inf"))
    live = torch.arange(Lp) < L
    dq_acc = torch.zeros(B, H, nq * TILE, D)
    dk, dv = torch.zeros(B, H, Lp, D), torch.zeros(B, H, Lp, D)
    for kb in range(nkb):
        for j in range(nq):
            qs = slice(j * TILE, (j + 1) * TILE)
            qt, dot, lt, dt = qh[:, :, qs], goh[:, :, qs], lsep[:, :, qs], delta[:, :, qs]
            part, ds_all, k_all = [], [], []
            for w in range(2):  # a consumer warpgroup's 64 keys
                ks = slice(kb * 2 * TILE + w * TILE, kb * 2 * TILE + (w + 1) * TILE)
                kt, vt = kh[:, :, ks], vh[:, :, ks]
                st = kt @ qt.transpose(-1, -2)
                pt = torch.where(live[ks, None], torch.exp(st * scale - lt[:, :, None]), 0.0)
                dpt = vt @ dot.transpose(-1, -2)
                dst = _bf(pt * (dpt - dt[:, :, None]) * ds_scale)
                dv[:, :, ks] += _bf(pt) @ dot
                dk[:, :, ks] += dst @ qt
                part.append(dst.transpose(-1, -2) @ kt)
                ds_all.append(dst)
                k_all.append(kt)
            # one box: each half's partial, summed; two boxes: each box of
            # dS K over the item's 128 keys in one product
            x = (part[0] + part[1] if D <= 64 else
                 torch.cat(ds_all, -2).transpose(-1, -2) @ torch.cat(k_all, -2))
            dq_acc[:, :, qs] = x if kb == 0 else dq_acc[:, :, qs] + x

    def back(x):  # (B, H, >= L, D) -> (B, L, H, D) bf16 values
        return _bf(x[:, :, :L].permute(0, 2, 1, 3))

    return back(dq_acc), back(dk), back(dv)


def _forward(q, k, v):
    """the streamed forward's out (bf16 values, (B, L, H D)) and lse (B, H,
    L) f32 for bf16-valued q, k, v"""
    from osu_dreamer_tpu_torch.ops.long_attention import attention_plain

    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D**-0.5
    return _bf(attention_plain(q.to(torch.bfloat16), k.to(torch.bfloat16),
                               v.to(torch.bfloat16)).float()), s.logsumexp(-1)


@pytest.mark.parametrize("L", [1, 65, 300])
@pytest.mark.parametrize("D", [8, 12, 64, 96, 128])
def test_one_pass_emulation_holds_grad_rel(D, L):
    """the one-pass kernel's order against f32 autograd of the plain version
    and against the JAX VJP (Pallas forward in interpret mode), under
    GRAD_REL; at L 1 dq and dk exactly 0"""
    import jax
    import jax.numpy as jnp

    from osu_dreamer_tpu.ops.long_attention import long_flash_attention as jax_attention
    from osu_dreamer_tpu_torch.ops.long_attention import attention_bwd_plain

    B, H = 2, 2
    q, k, v, go = _inputs(B, L, H, D, seed=7 * D + L)
    out, lse = _forward(q, k, v)
    got = bwd_emulation(q, k, v, out, lse, go)
    ref = attention_bwd_plain(q, k, v, go)
    _, pullback = jax.vjp(lambda a, b, c: jax_attention(a, b, c, True),
                          *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = pullback(jnp.asarray(go.numpy()))
    for name, g, r, w in zip(("dq", "dk", "dv"), got, ref, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == (B, L, H, D) and bool(torch.isfinite(g).all()), name
        assert (g - r).abs().max().item() <= GRAD_REL * r.abs().max().item(), name
        assert (g - w).abs().max().item() <= GRAD_REL * w.abs().max().item(), name
    if L == 1:
        assert not got[0].any() and not got[1].any()


def _source() -> str:
    from osu_dreamer_tpu_torch.ops import long_attention

    return (Path(long_attention.__file__).parent.parent / "csrc" / "long_attention_bwd.cu").read_text()


def _plan(nb: int) -> dict:
    """``LbPlan<NB>`` and the file's constants evaluated at NB = ``nb`` from
    the source's own expressions"""
    from test_torch_fused_attention_core import _c_to_py

    src = _source()
    env = {"NB": nb, "lb_min": min, "kMaxSmem": MAX_SMEM}
    for const in ("kLbRows", "kLbBox", "kLbConsumers", "kLbItemRows", "kLbThreads", "kLbWriters",
                  "kLbMaxStages", "kLbCap"):
        expr = re.search(rf"constexpr \w+ {const} = ([^;]+);", src)[1]
        env[const] = eval(_c_to_py(expr), env)
    body = re.search(r"struct LbPlan {(.*?)\n};", src, re.S)[1]
    for key, expr in re.findall(r"static constexpr \w+ (\w+) =\s*([^;]+);", body):
        env[key] = eval(_c_to_py(expr.replace("sizeof(uint64_t)", "8")), env)
    return env


@pytest.mark.parametrize("nb", [1, 2])
def test_one_pass_plan_fits_shared_memory(nb):
    """the one-pass kernel's plan at one box a head (Dp <= 64) and two (Dp
    <= 128), mirrored here: items of 128 key rows (two consumer warpgroups
    of 64 keys), K and V in two copies where the rest fits beside them, the
    dS^T tiles (two sets at two boxes), a tile's f32 dQ part (64 x 64 a box)
    in two buffers where they fit, a tile's dQ accumulator read back, then
    at least two ring stages of Q, dO, lse and delta, the barriers and 1024
    bytes to align, within a block's 227 KB; the registers the producer
    warpgroup hands over cover a consumer's dK, dV, S^T, dP^T and bf16 P^T
    (then dS^T) (its dQ partial reuses S^T's registers)"""
    got = _plan(nb)
    box = 64 * 64 * 2
    cap = MAX_SMEM - 1024 - 256
    assert got["kLbItemRows"] == 2 * TILE and got["kLbThreads"] == 3 * 128
    held, dq = 4 * nb * box, nb * 32 * 128 * 4
    fixed = 2 * nb * box + dq  # the dS^T tiles and the accumulator read back
    stage, rows = 2 * nb * box, 2 * TILE * 4
    hold = 2 if cap >= 2 * held + fixed + 2 * dq + 2 * (stage + rows) else 1
    bufs = 2 if cap >= hold * held + fixed + 2 * dq + 2 * (stage + rows) else 1
    stages = min(4, (cap - hold * held - fixed - bufs * dq) // (stage + rows))
    smem = hold * held + fixed + bufs * dq + stages * (stage + rows) + 8 * (2 * stages + 13) + 1024
    assert (got["kHold"], got["kDqBufs"], got["kStages"], got["kSmem"]) == (hold, bufs, stages, smem)
    assert (hold, bufs, stages) == ((2, 2, 4) if nb == 1 else (1, 1, 2))
    assert smem <= MAX_SMEM
    src = _source()
    assert "setmaxnreg_dec<P::kProducerRegs>" in src and "setmaxnreg_inc<P::kConsumerRegs>" in src
    producer, consumer = got["kProducerRegs"], got["kConsumerRegs"]
    assert (producer, consumer) == ((64, 216) if nb == 1 else (40, 232))
    assert producer * 128 + consumer * 2 * 128 <= SM_REGS
    assert consumer >= 2 * nb * 32 + 2 * 32 + 16


def test_one_pass_takes_every_head_dim_to_128():
    """the wrapper's limit is the source's: every head dim whose padded
    width is at most 128 (one or two 64-column boxes) takes the one-pass
    kernel, the entry refuses wider rows"""
    from osu_dreamer_tpu_torch.ops.long_attention import ONE_PASS_DIM, stream_dim

    src = _source()
    assert "Dp > 2 * 64" in src and ONE_PASS_DIM == 2 * 64
    assert "if (Dp <= 64)\n    return bwd_launch<1>" in src
    takes = [D for D in range(1, 385) if stream_dim(D) <= ONE_PASS_DIM]
    assert takes == list(range(1, 129))
