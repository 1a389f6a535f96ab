"""Tensor parallelism in the port across processes and through the fits, on
the CPU (tests/test_torch_parallel_tp.py has the TP forms and the one-step
checks against the one-process and JAX steps):
- two coordinator processes of two ranks each at tp 2: the model groups
  stay on their host and the step equals the one-process step;
- a tensor-parallel ``fit-denoiser`` writes the one-process checkpoint
  layout, resumes from it exactly, and its export loads into the JAX
  ``load_inference``; ``fit-style`` under tp 2 ends where the one-process
  fit ends.

Rank bodies are module-level functions that import no jax (a spawned rank
imports this module). Every spawn is bounded.
"""

from __future__ import annotations

import functools
import multiprocessing as std_mp
from pathlib import Path

import numpy as np
import torch

from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
from osu_dreamer_tpu_torch.parallel.distributed import free_port
from test_torch_parallel import COLLECTIVE_S, DEADLINE_S, TINY_DIFFUSION, TINY_LATENT, TINY_STYLE
from test_torch_parallel_tp import F32, L_DENOISER, _batch, _close, _step

torch.set_num_threads(1)


# ----------------------------------------------------------- multi-host ----


def _hybrid_rank(out: str, port: int, seed: int, batch_np, draws_np) -> None:
    """one rank of a host's two: the host's rows of the global batch"""
    pid = int(__import__("os").environ["GROUP_RANK"])
    par = build_parallelism(
        ParallelArgs(tp=2, coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid),
        batch_size=4, devices=["cpu", "cpu"], timeout_s=COLLECTIVE_S)
    rows = slice(2 * pid, 2 * pid + 2)
    got = _step("denoiser", par, seed, 1.0, batch_np, draws_np, host_rows=rows)
    model_group = [r for r in range(par.world_size) if r // par.tp == par.rank // par.tp]
    torch.save({"loss": got["metrics"]["loss"], "norm": got["norm"], "rank": par.rank,
                "host": pid,
                "model_group": model_group, "local_batch": par.local_batch_size,
                "params": got["state"]["params"]}, Path(out) / f"rank{par.rank}.pt")


def _hybrid_host(pid: int, port: int, out: str, seed: int, batch_np, draws_np) -> None:
    """one host of two, each with two CPU devices: it launches its two ranks"""
    par = build_parallelism(
        ParallelArgs(tp=2, coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid),
        batch_size=4, devices=["cpu", "cpu"], timeout_s=COLLECTIVE_S)
    assert par.needs_launch and par.world_size == 4 and par.n_local == 2
    par.launch(_hybrid_rank, out, port, seed, batch_np, draws_np)


def test_multihost_hybrid_dp_tp(tmp_path):
    """two coordinator processes of two CPU devices each, tp 2 (the JAX
    ``test_multihost_hybrid_dp_tp``): a (data=2, model=2) grid whose model
    groups stay on their host, each host loading half the global batch; the
    ranks' losses equal each other and the one-process loss on the whole
    batch, and the model groups hold the same parameters"""
    seed = 7
    batch_np = _batch("denoiser", seed, 4)
    gen = torch.Generator().manual_seed(seed)
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t

    draws_np = (stratified_logit_normal_t(4, gen, "cpu").numpy(),
                torch.randn(4, L_DENOISER, 6, generator=gen).numpy())
    port = free_port()
    ctx = std_mp.get_context("spawn")
    procs = [ctx.Process(target=_hybrid_host, args=(pid, port, str(tmp_path), seed, batch_np,
                                                    draws_np)) for pid in range(2)]
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
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    assert [r["host"] for r in ranks] == [0, 0, 1, 1]
    assert [r["model_group"] for r in ranks] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert {r["local_batch"] for r in ranks} == {2}
    ref = _step("denoiser", None, seed, 1.0, batch_np, draws_np)
    for r in ranks:
        _close(r["loss"], ref["metrics"]["loss"], f"loss rank {r['rank']}")
        np.testing.assert_allclose(r["norm"], ref["norm"], rtol=1e-5, err_msg="norm")
        for k, v in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], v), k


# ----------------------------------------------------------------- fits ----


def _fit_config(tmp: Path, run_dir: str, max_steps: int, parallel: dict,
                stage: str = "denoiser") -> dict:
    fit = {"run_dir": str(tmp / run_dir), "max_steps": max_steps, "log_every": 100,
           "save_last_every_s": 0.0}
    if stage == "style":
        from osu_dreamer_tpu_torch.data.synth import write_latent_corpus

        data = tmp / "data"
        if not data.exists():
            write_latent_corpus(data, 6, 3, 20, 16, 4, 8, seed=1)
        return {"data": {"data_dir": str(data), "batch_size": 4, "shuffle_buffer": 8,
                         "max_val_count": 2, "max_val_frac": 0.4},
                "fit": {**fit, "monitor": "val/energy_dist"},
                "train": {"opt": {"schedule": {"warmup_init": 0.3, "warmup_steps": 10}}},
                "model": TINY_STYLE, "parallel": parallel}
    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus

    data = tmp / "data"
    if not data.exists():
        write_latent_corpus(data, 4, 2, 100, 16, 6, 8, seed=1)
    return {
        "data": {"data_dir": str(data), "seq_len": 24, "batch_size": 4, "max_per_map": -1,
                 "shuffle_buffer": 8},
        "fit": fit,
        "train": {"val_batches": 2, "opt": {"schedule": {"warmup_init": 0.3,
                                                         "warmup_steps": 10}}},
        "model": TINY_DIFFUSION,
        "parallel": parallel,
    }


def _interrupt(at: int, step: int, metrics: dict) -> None:
    if step == at:
        raise KeyboardInterrupt


def test_tp_checkpoint_resume_and_export(tmp_path, monkeypatch, capsys):
    """fit-denoiser at tp 2: rank 0's checkpoint holds the gathered whole
    state in the one-process layout (it loads into a one-process state);
    interrupted after step 2 and resumed from it, the run ends bit for bit
    where four straight steps end; the checkpoint's export loads into the
    JAX ``load_inference`` with the run's EMA weights"""
    from osu_dreamer_tpu_torch.models.diffusion.fit import run
    from osu_dreamer_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "COLLECTIVE_TIMEOUT_S", COLLECTIVE_S)
    two = ["cpu", "cpu"]
    straight = run(_fit_config(tmp_path, "a", 4, {"tp": 2}), device="cpu", devices=two)
    assert "tensor-parallel: (data=1, model=2)" in capsys.readouterr().out
    run(_fit_config(tmp_path, "b", 4, {"tp": 2}), device="cpu", devices=two,
        on_step=functools.partial(_interrupt, 2))
    saved = torch.load(tmp_path / "b" / "last" / "state.pt", weights_only=True)
    assert saved["step"] == 2
    whole = straight.state_dict()
    for part in ("params", "ema_params"):
        assert {k: v.shape for k, v in saved[part].items()} == \
            {k: v.shape for k, v in whole[part].items()}
    resumed = run(_fit_config(tmp_path, "b", 4, {"tp": 2}), str(tmp_path / "b" / "last"),
                  device="cpu", devices=two)
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 4
    for part in ("params", "ema_params"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert torch.equal(x, y)

    # the export of the tensor-parallel checkpoint, read by the JAX package
    from osu_dreamer_tpu.models.inference.artifact import load_inference as jload
    from osu_dreamer_tpu_torch.models.inference.artifact import _flatten, save_inference
    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs
    from osu_dreamer_tpu_torch.models.latent.train import LatentTrainArgs, init_latent_training
    from osu_dreamer_tpu_torch.models.style.model import StyleModelArgs
    from osu_dreamer_tpu_torch.models.style.train import StyleTrainArgs, init_style_training
    from osu_dreamer_tpu_torch.train.checkpoint import save_train_checkpoint
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    paths = []
    for name, init, margs, targs, cfg in (
            ("latent", init_latent_training, LatentModelArgs, LatentTrainArgs(), TINY_LATENT),
            ("style", init_style_training, StyleModelArgs, StyleTrainArgs(), TINY_STYLE)):
        state, _ = init(dataclass_from_dict(margs, cfg), targs, 0, "cpu", F32)
        save_train_checkpoint(tmp_path / name, state, {"model": cfg, "train": {}}, 0.0)
        paths.append(tmp_path / name)
    out = tmp_path / "inference.odt"
    save_inference(paths[0], tmp_path / "a" / "last", paths[1], out, device="cpu")
    _, jparams = jload(out)
    got = _flatten(jparams["params"]["diffusion"]) if "params" in jparams else \
        _flatten(jparams["diffusion"])
    assert set(got) == set(a["ema_params"])
    for key, value in a["ema_params"].items():
        np.testing.assert_array_equal(np.asarray(got[key]), value.numpy(), err_msg=key)


def test_fit_style_under_tp_equals_one_process(tmp_path, monkeypatch):
    """fit-style at tp 2: no leaf is split, the model group computes the
    same rows, and three steps end where the one-process fit ends (within
    1e-5 of the largest parameter), the ranks' replicas equal"""
    from osu_dreamer_tpu_torch.models.style.fit import run
    from osu_dreamer_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "COLLECTIVE_TIMEOUT_S", COLLECTIVE_S)
    spread = run(_fit_config(tmp_path, "tp", 3, {"tp": 2}, "style"), device="cpu",
                 devices=["cpu", "cpu"])
    single = run(_fit_config(tmp_path, "one", 3, {"dp": 1}, "style"), device="cpu")
    assert spread.step == single.step == 3
    params = [p.detach() for p in single.model.parameters()]
    gmax = max(float(p.abs().max()) for p in params)
    for got, want in zip(spread.model.parameters(), params):
        assert float((got.detach() - want).abs().max()) <= 1e-5 * gmax
