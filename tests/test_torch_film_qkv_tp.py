"""The fused prologue's TP forms (ops/film_qkv.py ``film_qkv_tp``: K11 on a
rank's [q|k|v] columns, K12 split at its dy) on the CPU, in f32:
- the plain forms on every rank's columns, 2 and 3 ranks and uneven head
  splits (6/5/5 of 16), put together equal the one-rank prologue and its
  autograd gradient;
- every rank of a model group takes the same route (``prologue_tp_ok``):
  the TP forms where every rank's qkv width passes the JAX rule, the torch
  prologue on every rank where one fails (16 x 64 heads over 3 ranks);
- with ``OSU_DREAMER_FUSED_PROLOGUE=1`` one step of a denoiser on two gloo
  ranks through the TP forms equals the port's one-process step and the JAX
  package's unsharded step (``_check_step`` of
  tests/test_torch_parallel_tp.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.ops import film_qkv as fq
from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
from osu_dreamer_tpu_torch.parallel.tp import Split, even_split
from test_torch_parallel import COLLECTIVE_S, TINY_DIFFUSION, spawn
from test_torch_parallel_tp import B_DENOISER, _batch, _check_step, _jax_denoiser, _init, _step

torch.set_num_threads(1)


def _t(rng, *shape, scale=1.0) -> torch.Tensor:
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _counted(calls: dict, name: str, fn):
    """``fn`` adding one to ``calls[name]`` at each call"""
    def wrapper(*args, **kwargs):
        calls[name] += 1
        return fn(*args, **kwargs)
    return wrapper


def _qkv_splits(heads: int, D: int, tp: int) -> list[tuple[Split, Split]]:
    """per rank the splits of the packed [q|k|v] kernel's columns and bias,
    as parallel/tp.py ``DEFAULT_TP_RULES`` cuts them"""
    out = []
    for r in range(tp):
        lo, hi = even_split(heads, tp, r)
        out.append((Split(1, 3, D, heads, lo, hi), Split(0, 3, D, heads, lo, hi)))
    return out


@pytest.mark.parametrize("heads, D, tp", [(16, 8, 2), (16, 8, 3), (5, 8, 2), (3, 16, 3),
                                          (7, 4, 3)])
def test_plain_tp_forms_sum_to_the_one_rank_prologue(heads, D, tp):
    """each rank's forward equals its columns of ``film_qkv_plain``; the
    ranks' dy partials summed (the all-reduce) and finished, and the
    slices' dW and db put together, equal autograd of ``film_qkv_plain``
    (f32, 1e-5 of each gradient's largest magnitude); every rank finishes
    the same sum bit for bit"""
    rng = np.random.default_rng(heads * 10 + tp)
    B, L, C = 2, 9, 32
    F = 3 * heads * D
    x, add = _t(rng, B, L, C), _t(rng, B, L, C, scale=0.5)
    scale, shift = _t(rng, B, C, scale=0.3), _t(rng, B, C, scale=0.3)
    kernel, bias, g = _t(rng, C, F, scale=C ** -0.5), _t(rng, F, scale=0.1), _t(rng, B, L, F)
    whole = fq.film_qkv_plain(x, scale, shift, add, kernel, bias).reshape(B * L, F)
    ref = fq.film_qkv_bwd_plain(x, scale, shift, add, kernel, bias, g)
    dw, db, dys, finishes = torch.zeros_like(kernel), torch.zeros_like(bias), [], []
    for sk, sb in _qkv_splits(heads, D, tp):
        kr, br = sk.take(kernel), sb.take(bias)
        gr = sk.take(g.reshape(B * L, F)).reshape(B, L, -1)
        out = fq.film_qkv_plain(x, scale, shift, add, kr, br)
        torch.testing.assert_close(out.reshape(B * L, -1), sk.take(whole), rtol=0, atol=1e-6)
        dy, (dwr, dbr), finish = fq.film_qkv_tp_bwd(x, scale, shift, add, kr, br, gr)
        sk.put(dw, dwr)
        sb.put(db, dbr)
        dys.append(dy)
        finishes.append(finish)
    total = sum(dys)
    for dy in dys:
        dy.copy_(total)
    finished = [finish() for finish in finishes]
    for f in finished[1:]:
        assert all(torch.equal(a, b) for a, b in zip(f, finished[0]))
    names = ("dx", "dscale", "dshift", "dadd", "dkernel", "dbias")
    for name, got, want in zip(names, (*finished[0], dw, db), ref):
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= 1e-5 * top, f"{name}: {err:.3g} vs 1e-5 x {top:.3g}"


@pytest.mark.parametrize("heads, D, tp, takes", [(16, 64, 2, True), (16, 64, 3, False),
                                                 (16, 64, 4, True), (8, 128, 3, True),
                                                 (6, 64, 4, False), (10, 64, 4, False),
                                                 (12, 64, 3, True)])
def test_every_rank_takes_one_route(monkeypatch, heads, D, tp, takes):
    """each rank's ``RoPEAttention`` (its heads sliced by ``shard_model``)
    runs the prologue's TP forms exactly where every rank's qkv width 3 x
    heads_r x D is a multiple of 128 (16 x 64 over 3 ranks: 6/5/5 heads,
    1152/960/960 columns, so the torch prologue on all three), and its
    input enters the model group only on the torch route"""
    import osu_dreamer_tpu_torch.nn.attention as attn_mod
    from osu_dreamer_tpu_torch.nn.attention import RoPEAttention
    from osu_dreamer_tpu_torch.parallel.tp import shard_model

    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "1")
    calls = {"film_qkv_tp": 0, "enter_model": 0}
    for name in calls:
        monkeypatch.setattr(attn_mod, name, _counted(calls, name, getattr(attn_mod, name)))
    rng = np.random.default_rng(0)
    C, L = 128, 5
    x = _t(rng, 1, L, C)
    film = (_t(rng, 1, C, scale=0.3), _t(rng, 1, C, scale=0.3))
    routes = []
    for rank in range(tp):
        torch.manual_seed(0)
        net = torch.nn.Module()
        net.attn = RoPEAttention(C, heads, D, C, torch.float32)
        shard_model(net, None, rank, tp)
        assert net.attn.tp is not None
        before = dict(calls)
        net.attn(x, film=film)
        routes.append({k: calls[k] - before[k] for k in calls})
    want = {"film_qkv_tp": int(takes), "enter_model": int(not takes)}
    assert routes == [want] * tp
    shares = {hi - lo for lo, hi in (even_split(heads, tp, r) for r in range(tp))}
    assert attn_mod.prologue_tp_ok(C, heads, D, tp) == takes == all(
        3 * n * D % 128 == 0 for n in shares)


# four heads of 64: two a rank, 384 qkv columns each (the gate's 128 multiple)
PROLOGUE_DIFFUSION = {**TINY_DIFFUSION,
                      "backbone": {**TINY_DIFFUSION["backbone"], "n_heads": 4}}


def _prologue_rank(out: str, seed: int, grad_clip: float, batch_np, draws_np) -> None:
    """one tp 2 step with the prologue on, counting each rank's TP-form and
    torch-prologue calls"""
    import osu_dreamer_tpu_torch.nn.attention as attn_mod

    calls = {"film_qkv_tp": 0, "enter_model": 0}
    for name in calls:
        setattr(attn_mod, name, _counted(calls, name, getattr(attn_mod, name)))
    par = build_parallelism(ParallelArgs(tp=2), batch_np[0].shape[0], ["cpu"] * 2,
                            timeout_s=COLLECTIVE_S)
    got = _step("denoiser", par, seed, grad_clip, batch_np, draws_np, model=PROLOGUE_DIFFUSION)
    torch.save({**got, "rank": par.rank, "model_group": par.model_rank, "calls": calls},
               Path(out) / f"rank{par.rank}.pt")


def test_tp_prologue_step_equals_one_process_and_jax(tmp_path, monkeypatch):
    """with ``OSU_DREAMER_FUSED_PROLOGUE=1``, one step of a denoiser of 4 x
    64 heads on two tensor-parallel ranks runs each backbone layer's
    prologue through the TP forms (two a step forward: depth 2; no torch
    prologue) and equals the port's one-process step (whose prologue is
    the one-rank ``film_qkv``) and the JAX package's unsharded step on the
    same weights and draws, by ``_check_step``'s tolerances"""
    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "1")
    seed, grad_clip = 8, 1.0
    batch_np = _batch("denoiser", seed, B_DENOISER)
    whole, _, _ = _init("denoiser", None, seed, grad_clip, model=PROLOGUE_DIFFUSION)
    draws_np, jax_metrics, jax_params, jax_grads = _jax_denoiser(
        whole.model.state_dict(), batch_np, grad_clip, 4, model=PROLOGUE_DIFFUSION)
    spawn(_prologue_rank, str(tmp_path), seed, grad_clip, batch_np, draws_np)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    depth = PROLOGUE_DIFFUSION["backbone"]["depth"]
    for rank in ranks:
        assert rank["calls"]["film_qkv_tp"] == 2 * depth, rank["calls"]  # step_gradients, step
        assert rank["calls"]["enter_model"] == 0, rank["calls"]
    ref = _step("denoiser", None, seed, grad_clip, batch_np, draws_np, model=PROLOGUE_DIFFUSION)
    _check_step(ranks, ref, jax_metrics, jax_params, 3e-4 * 0.3, ("loss", "osl", "del"),
                jax_grads)
