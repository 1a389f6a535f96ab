"""Data parallelism in the port on spawned gloo ranks on the CPU: one step of
each stage on dp ranks equal to the single-process step on the whole batch
with the same injected draws (f32; the ranks' parameters equal bit for
bit), the latent MMD over the global batch, two processes joined through
``coordinator``/``num_processes``/``process_id``, the lockstep truncation on
ragged shards, a failing or hanging rank failing the launch, a fit spread
by ``dp: -1`` and a kill-and-resume from rank 0's checkpoint.

Rank bodies are module-level functions that import no jax (a spawned rank
imports this module); each writes what it saw under the test's tmp_path.
Every spawn is bounded (tests/test_torch_parallel.py ``spawn``).
"""

from __future__ import annotations

import functools
import json
import multiprocessing as std_mp
from pathlib import Path

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
from osu_dreamer_tpu_torch.parallel.distributed import free_port
from test_torch_parallel import (
    COLLECTIVE_S, DEADLINE_S, TINY_DIFFUSION, TINY_LATENT, TINY_STYLE, randomize_, spawn,
)

torch.set_num_threads(1)
F32 = torch.float32
B_DENOISER, L_DENOISER = 4, 24
B_LATENT, L_LATENT = 2, 36
B_STYLE = 6


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- one step ----


def _denoiser_step(par, seed: int) -> dict:
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, init_diffusion_training, step_gradients,
    )
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    margs = dataclass_from_dict(DiffusionModelArgs, TINY_DIFFUSION)
    targs = DiffusionTrainArgs()
    state, train_step = init_diffusion_training(margs, targs, 0, "cpu", F32, par)
    randomize_(state.model, seed)
    state.ema_model.load_state_dict(state.model.state_dict())
    rng = _rng(seed)
    B, L = B_DENOISER, L_DENOISER
    batch = LatentBatch(_t(rng.random((B, L, 16), dtype=np.float32)),
                        _t(rng.standard_normal((B, L, 6)).astype(np.float32)),
                        _t(rng.standard_normal((B, 8)).astype(np.float32)),
                        _t(rng.uniform(0, 10, (B, 5)).astype(np.float32)))
    gen = torch.Generator().manual_seed(seed)
    t = stratified_logit_normal_t(B, gen, "cpu")
    x0 = torch.randn(B, L, 6, generator=gen)
    local = par.shard_batch(batch) if par is not None else batch
    metrics, grads = step_gradients(state.model, local, targs, None, t, x0, par)
    train_step(state, local, t, x0)
    return {"metrics": metrics, "grads": grads, "params": list(state.model.parameters()),
            "ema": list(state.ema_model.parameters()), "lr0": _lr0(state)}


def _latent_step(par, seed: int) -> dict:
    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        Batch, LatentTrainArgs, draw_latent, init_latent_training, step_gradients,
    )
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    margs = dataclass_from_dict(LatentModelArgs, TINY_LATENT)
    targs = LatentTrainArgs()
    state, train_step = init_latent_training(margs, targs, 0, "cpu", F32, par)
    randomize_(state.model, seed)
    rng = _rng(seed)
    B, L = B_LATENT, L_LATENT
    batch = Batch(_t(rng.random((B, L, 72), dtype=np.float32)),
                  _t(rng.random((B, L, 9), dtype=np.float32)),
                  _t(rng.uniform(0, 10, (B, 5)).astype(np.float32)))
    draws = draw_latent(2 * B, 8, L // 2 // 9, 4, torch.Generator().manual_seed(seed), "cpu")
    local = par.shard_batch(batch) if par is not None else batch
    comps, aux, grads = step_gradients(state, local, targs, draws, par)
    train_step(state, local, draws)
    return {"metrics": {"components": comps, "s_reg": aux["s_reg"], "loss": aux["loss"]},
            "grads": grads,
            "params": list(state.model.parameters()), "loss_ema": state.loss_ema,
            "lr0": _lr0(state)}


def _style_step(par, seed: int) -> dict:
    from osu_dreamer_tpu_torch.models.style.model import StyleModelArgs
    from osu_dreamer_tpu_torch.models.style.train import (
        StyleTrainArgs, init_style_training, step_gradients,
    )
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    margs = dataclass_from_dict(StyleModelArgs, TINY_STYLE)
    targs = StyleTrainArgs()
    state, train_step = init_style_training(margs, targs, 0, "cpu", F32, par)
    randomize_(state.model, seed)
    state.ema_model.load_state_dict(state.model.state_dict())
    rng = _rng(seed)
    B = B_STYLE
    batch = (_t(rng.standard_normal((B, 8)).astype(np.float32)),
             _t(rng.uniform(0, 10, (B, 5)).astype(np.float32)))
    gen = torch.Generator().manual_seed(seed)
    t, s0 = stratified_logit_normal_t(B, gen, "cpu"), torch.randn(B, 8, generator=gen)
    drop = torch.rand(B, 5, generator=gen) < targs.label_drop_prob
    local = par.shard_batch(batch) if par is not None else batch
    metrics, grads = step_gradients(state.model, local, targs, None, t, s0, drop, par)
    train_step(state, local, t, s0, drop)
    return {"metrics": metrics, "grads": grads, "params": list(state.model.parameters()),
            "ema": list(state.ema_model.parameters()), "lr0": _lr0(state)}


STEPS = {"denoiser": (_denoiser_step, B_DENOISER), "latent": (_latent_step, B_LATENT),
         "style": (_style_step, B_STYLE)}


def _step_rank(out: str, stage: str, dp: int, seed: int) -> None:
    fn, batch = STEPS[stage]
    par = build_parallelism(ParallelArgs(dp=dp), batch, ["cpu"] * dp, timeout_s=COLLECTIVE_S)
    torch.save(fn(par, seed), Path(out) / f"rank{par.rank}.pt")


def _close(got, want, what: str, rtol: float = 1e-5, atol: float = 0.0) -> None:
    """f32 within ``rtol`` of the largest magnitude (sums differ only in
    their order), plus ``atol``"""
    got, want = got.detach().double(), want.detach().double()
    if want.numel() == 0:
        return
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= rtol * scale + atol, \
        f"{what}: max |err| {err:.3g} vs {rtol:g} x {scale:.3g} + {atol:.3g}"


def _lr0(state) -> float:
    """the first update's learning rate"""
    return float(state.opt.schedule(0))


@pytest.mark.parametrize("stage, dp", [("denoiser", 2), ("denoiser", 4), ("latent", 2),
                                       ("style", 2)])
def test_dp_step_equals_the_single_process_step(tmp_path, stage, dp):
    """one step of ``stage`` on dp ranks, each on its rows with the global
    draws, equals the single-process step on the whole batch: the metrics
    within 1e-5 relative, the averaged gradients within 1e-5 of the largest,
    the parameters after clip + AdamW (and the EMA) within 1e-5 of the
    largest plus 5 % of the step's learning rate where the gradient stands
    above the sums' rounding (1e-5 of the largest), and within one step
    elsewhere: Adam's first step is g / (|g| + 1e-8) times the rate, so a
    gradient that is 0 in one sum order and 2e-7 in another moves its
    element by a whole step; every rank's parameters equal bit for bit"""
    seed = 3
    spawn(_step_rank, str(tmp_path), stage, dp, seed, ranks=dp)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(dp)]
    ref = STEPS[stage][0](None, seed)
    for key in ref["metrics"]:
        _close(ranks[0]["metrics"][key], ref["metrics"][key], key)
    gmax = max(float(g.abs().max()) for g in ref["grads"])
    for i, (got, want) in enumerate(zip(ranks[0]["grads"], ref["grads"])):
        assert float((got - want).abs().max()) <= 1e-5 * gmax, f"gradient {i}"
    lr0 = ref["lr0"]
    for part in ("params", "ema"):
        if part not in ref:
            continue
        share = 1.0 if part == "params" else 0.01  # the EMA moves 1 % of a step
        for i, (w, g_ref) in enumerate(zip(ref[part], ref["grads"])):
            settled = g_ref.abs() >= 1e-5 * gmax
            for r, rank in enumerate(ranks):
                g = rank[part][i]
                assert torch.equal(g, ranks[0][part][i]), (part, r, i)
                _close(g[settled], w[settled], f"{part} {i}", atol=0.05 * lr0 * share)
                _close(g, w, f"{part} {i}", atol=1.05 * lr0 * share)
    if "loss_ema" in ref:
        for rank in ranks:
            _close(rank["loss_ema"], ref["loss_ema"], "loss_ema")


# ------------------------------------------------------------------ MMD ----


def _mmd_rank(out: str, s_np: np.ndarray, prior_np: np.ndarray) -> None:
    from osu_dreamer_tpu_torch.nn.mmd import mmd_imq
    from osu_dreamer_tpu_torch.parallel.collectives import all_gather_rows

    par = build_parallelism(ParallelArgs(dp=2), 4, ["cpu"] * 2, timeout_s=COLLECTIVE_S)
    s = torch.from_numpy(s_np[par.rank * 2:(par.rank + 1) * 2]).requires_grad_()
    value = mmd_imq(all_gather_rows(s, par.data_group), torch.from_numpy(prior_np))
    (grad,) = torch.autograd.grad(value, [s])
    torch.save({"value": value.detach(), "grad": grad}, Path(out) / f"rank{par.rank}.pt")


def test_latent_mmd_runs_over_the_global_batch(tmp_path):
    """the style codes gathered over the data ranks: every rank's MMD is the
    MMD of the whole batch, and each rank's gradient is the rank count times
    its rows of the whole batch's gradient (the average over the ranks of a
    replicated parameter's gradient then sums the rows' shares once)"""
    from osu_dreamer_tpu_torch.nn.mmd import mmd_imq

    rng = _rng(5)
    s, prior = (rng.standard_normal((4, 8)).astype(np.float32) for _ in range(2))
    spawn(_mmd_rank, str(tmp_path), s, prior)
    st = torch.from_numpy(s).requires_grad_()
    want = mmd_imq(st, torch.from_numpy(prior))
    (want_grad,) = torch.autograd.grad(want, [st])
    local = mmd_imq(st[:2], torch.from_numpy(prior[:2])).detach()
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt")
        _close(got["value"], want, "mmd")
        assert abs(float(local) - float(want.detach())) > 1e-3  # a local MMD would differ
        _close(got["grad"], want_grad[r * 2:(r + 1) * 2] * 2, f"grad rank {r}")


# ----------------------------------------------------------- multi-host ----


def _host_main(pid: int, port: int, out: str, windows: int) -> None:
    """one host of two, joined through the coordinator block (one CPU device
    a host: this process is the host's rank)"""
    par = build_parallelism(
        ParallelArgs(coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid),
        batch_size=8, devices=["cpu"], timeout_s=COLLECTIVE_S)
    n_shards, idx = par.input_shard
    items = list(range(10))[idx::n_shards]
    # the global batch: rows 0..7; this host materializes its 4 rows
    local = torch.arange(8, dtype=F32)[4 * pid:4 * pid + 4]
    w = torch.ones(1, requires_grad=True)
    (grad,) = torch.autograd.grad(((local * w) ** 2).mean(), [w])
    (grad,) = par.average_gradients([grad])
    lockstep = par.lockstep_steps(windows)
    steps = len(list(par.lockstep_stream(iter(range(windows // 4)), lockstep)))
    from osu_dreamer_tpu_torch.parallel import input_shard

    Path(out, f"host{pid}.json").write_text(json.dumps(
        {"rank": par.rank, "world": par.world_size, "local_batch": par.local_batch_size,
         "items": items, "grad": float(grad), "lockstep": lockstep, "steps": steps,
         "input_shard": list(input_shard())}))
    # leave the group this process joined: a process group left open at
    # interpreter exit can abort the process ("terminate called without an
    # active exception")
    torch.distributed.destroy_process_group()


def _run_hosts(target, *args, hosts: int = 2) -> None:
    """``target(pid, *args)`` in ``hosts`` spawned processes that join on
    their own (not through ``launch``), bounded like ``spawn``"""
    ctx = std_mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(pid, *args)) for pid in range(hosts)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=DEADLINE_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * hosts


def test_multihost_two_process_dp(tmp_path):
    """two processes through coordinator/num_processes/process_id on a free
    port (the JAX ``test_multihost_two_process_dp``): disjoint input shards
    covering the data, half the global batch each, and the averaged gradient
    of the global batch"""
    _run_hosts(_host_main, free_port(), str(tmp_path), 16)
    got = [json.loads((tmp_path / f"host{p}.json").read_text()) for p in range(2)]
    assert [g["rank"] for g in got] == [0, 1] and {g["world"] for g in got} == {2}
    assert {g["local_batch"] for g in got} == {4}
    assert [g["input_shard"] for g in got] == [[2, 0], [2, 1]]
    s0, s1 = set(got[0]["items"]), set(got[1]["items"])
    assert s0.isdisjoint(s1) and s0 | s1 == set(range(10))
    want = 2 * np.mean(np.arange(8) ** 2)  # d/dw mean((x w)^2) at w = 1
    for g in got:
        assert g["grad"] == pytest.approx(want, rel=1e-6)


def _ragged_host(pid: int, port: int, out: str) -> None:
    _host_main(pid, port, out, (16, 11)[pid])


def test_lockstep_truncation_on_ragged_shards(tmp_path):
    """hosts with 16 and 11 windows at 4 rows a host step: every host runs
    min(4, 2) = 2 steps an epoch, so the collectives stay in lockstep"""
    _run_hosts(_ragged_host, free_port(), str(tmp_path))
    got = [json.loads((tmp_path / f"host{p}.json").read_text()) for p in range(2)]
    assert [g["lockstep"] for g in got] == [2, 2]
    assert [g["steps"] for g in got] == [2, 2]


# ------------------------------------------------------- failing ranks ----


def _failing_rank(how: str) -> None:
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        if how == "raises":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(60)  # never joins the collective
    dist.all_reduce(torch.ones(1))


@pytest.mark.parametrize("how, message", [
    ("raises", "rank 1 fails on purpose"),
    ("hangs", "Timed out|timed out|timeout"),
], ids=["raises", "hangs"])
def test_a_failing_rank_fails_the_launch(how, message):
    """a rank's exception reaches the launcher with its traceback, and a
    rank left waiting in a collective fails at the process group's timeout
    (5 s here), long before the other rank would have joined"""
    import time

    from osu_dreamer_tpu_torch.parallel.distributed import launch

    t0 = time.monotonic()
    with pytest.raises(Exception, match=message):
        launch(_failing_rank, (how,), ["cpu", "cpu"], 2, timeout_s=5.0, deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 45


# ---------------------------------------------------------------- fits ----


def _fit_config(tmp: Path, run_dir: str, max_steps: int, parallel: dict) -> dict:
    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus

    data = tmp / "data"
    if not data.exists():
        write_latent_corpus(data, 4, 2, 100, 16, 6, 8, seed=1)
    return {
        "data": {"data_dir": str(data), "seq_len": 24, "batch_size": 4, "max_per_map": -1,
                 "shuffle_buffer": 8},
        "fit": {"run_dir": str(tmp / run_dir), "max_steps": max_steps, "log_every": 100,
                "save_last_every_s": 0.0},
        "train": {"val_batches": 2, "opt": {"schedule": {"warmup_init": 0.3,
                                                         "warmup_steps": 10}}},
        "model": dict(TINY_DIFFUSION, u_head_dim=8, global_cond_dim=16),
        "parallel": parallel,
    }


def _params(state) -> list[torch.Tensor]:
    return [p.detach() for p in state.model.parameters()]


def test_fit_auto_dp_spreads_over_the_devices(tmp_path, capsys, monkeypatch):
    """``dp: -1`` (the shipped configs' default) over two devices trains on
    two ranks, as the JAX package does, and ends where the single-process
    run ends (f32, three steps, within 1e-5 of the largest parameter); the
    ranks hold the same parameters and rank 0 alone wrote the checkpoints"""
    from osu_dreamer_tpu_torch.models.diffusion.fit import run
    from osu_dreamer_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "COLLECTIVE_TIMEOUT_S", COLLECTIVE_S)
    spread = run(_fit_config(tmp_path, "dp", 3, {"dp": -1}), device="cpu",
                 devices=["cpu", "cpu"])
    assert "[parallel] data-parallel over 2 devices" in capsys.readouterr().out
    single = run(_fit_config(tmp_path, "one", 3, {"dp": -1}), device="cpu")
    assert spread.step == single.step == 3
    gmax = max(float(p.abs().max()) for p in _params(single))
    for got, want in zip(_params(spread), _params(single)):
        assert float((got - want).abs().max()) <= 1e-5 * gmax
    assert (tmp_path / "dp" / "best" / "state.pt").exists()


def _interrupt(at: int, step: int, metrics: dict) -> None:
    if step == at:
        raise KeyboardInterrupt


def test_kill_and_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """two ranks interrupted after step 2 (both at once, as a Ctrl-C reaches
    every process), then resumed from rank 0's ``last``: the same
    parameters, optimizer moments, EMA and generator, bit for bit, as four
    uninterrupted steps (the JAX ``test_multihost_kill_resume_equality``)"""
    from osu_dreamer_tpu_torch.models.diffusion.fit import run
    from osu_dreamer_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "COLLECTIVE_TIMEOUT_S", COLLECTIVE_S)
    two = ["cpu", "cpu"]
    straight = run(_fit_config(tmp_path, "a", 4, {"dp": 2}), device="cpu", devices=two)
    run(_fit_config(tmp_path, "b", 4, {"dp": 2}), device="cpu", devices=two,
        on_step=functools.partial(_interrupt, 2))
    meta = json.loads((tmp_path / "b" / "last" / "meta.json").read_text())
    assert meta["step"] == 2 and meta["progress"] == {"epoch": 0, "batch_in_epoch": 2}
    resumed = run(_fit_config(tmp_path, "b", 4, {"dp": 2}), str(tmp_path / "b" / "last"),
                  device="cpu", devices=two)
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 4
    for part in ("params", "ema_params"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])
