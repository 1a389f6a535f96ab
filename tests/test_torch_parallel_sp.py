"""Sequence parallelism in the port (ops/ring_attention.py and the sp branches
of the denoiser) on spawned gloo ranks on the CPU, against the JAX package's
unsharded computations in f32: ring attention's output and gradients at sp 1,
2 and 4, the halo exchange at the global edges (and its refusal), the SP
denoiser forward and ``sample`` with injected noise, one SP train step at sp
2 and at dp 2 x sp 2 against the JAX ``diffusion_loss`` with weights from
``from_flax_params`` and the JAX draws injected, and ``fit-denoiser`` with
``parallel: {sp: 2}``.

JAX runs in the test process only: the rank bodies are module-level
functions that import no jax, and get numpy arrays.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
from test_torch_parallel import COLLECTIVE_S, TINY_DIFFUSION, spawn

torch.set_num_threads(1)
B, L = 4, 24  # the global batch and window


def _par(args: dict, ranks: int):
    return build_parallelism(ParallelArgs(**args), B, ["cpu"] * ranks, timeout_s=COLLECTIVE_S)


def _save(where: str, rank: int, **values) -> None:
    torch.save(values, Path(where) / f"rank{rank}.pt")


def _load(out: Path, ranks: int) -> list[dict]:
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(ranks)]


# -------------------------------------------------------- ring attention ----


def _qkv(seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32) for _ in range(4))
    return q, k, v, cot


def _ring(q, k, v, cot, group):
    from osu_dreamer_tpu_torch.ops.ring_attention import ring_attention

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ring_attention(*leaves, group)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    return out.detach(), grads


def _ring_rank(out: str, sp: int, seed: int) -> None:
    par = _par({"sp": sp}, sp)
    span = 16 // sp
    q, k, v, cot = (a[:, par.sp_rank * span:(par.sp_rank + 1) * span] for a in _qkv(seed))
    o, grads = _ring(q, k, v, cot, par.sp_group)
    _save(out, par.rank, out=o, grads=grads)


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_attention_matches_jax(tmp_path, sp):
    """each rank's span of the output and of dq/dk/dv (under each rank's
    share of a random cotangent) equals the JAX attention over the whole
    sequence (``_attention_einsum``) and its vjp, f32 within 2e-6"""
    import jax
    import jax.numpy as jnp

    from osu_dreamer_tpu.nn.attention import _attention_einsum

    q, k, v, cot = _qkv(sp)
    want, vjp = jax.vjp(_attention_einsum, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    if sp == 1:  # one rank: no group, no process
        ranks = [dict(zip(("out", "grads"), _ring(q, k, v, cot, None)))]
    else:
        spawn(_ring_rank, str(tmp_path), sp, sp, ranks=sp)
        ranks = _load(tmp_path, sp)
    span = 16 // sp
    for r, got in enumerate(ranks):
        sl = slice(r * span, (r + 1) * span)
        np.testing.assert_allclose(got["out"].numpy(), np.asarray(want)[:, sl], atol=2e-6)
        for name, g, w in zip("qkv", got["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), w[:, sl], atol=2e-6, err_msg=f"d{name}")


# ------------------------------------------------------------------ halo ----


def _halo_rank(out: str, x: np.ndarray, cot: np.ndarray) -> None:
    from osu_dreamer_tpu_torch.ops.ring_attention import halo_exchange

    par = _par({"sp": 3}, 3)
    xs = torch.from_numpy(x[:, par.sp_rank * 3:(par.sp_rank + 1) * 3]).requires_grad_()
    y = halo_exchange(xs, 2, par.sp_group)
    (g,) = torch.autograd.grad((y * torch.from_numpy(cot[par.sp_rank])).sum(), [xs])
    _save(out, par.rank, y=y.detach(), grad=g)


def test_halo_exchange_at_the_global_edges(tmp_path):
    """three shards of 3 frames, radius 2: each shard's halo'd rows are its
    window of the zero-padded sequence (zeros past the global edges, the
    unsharded SAME padding), and the gradient that comes back to each frame
    sums every rank's use of it"""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3)).astype(np.float32)
    cot = rng.standard_normal((3, 2, 7, 3)).astype(np.float32)
    spawn(_halo_rank, str(tmp_path), x, cot, ranks=3)
    xt = torch.from_numpy(x).requires_grad_()
    xp = torch.nn.functional.pad(xt, (0, 0, 2, 2))
    windows = [xp[:, 3 * r:3 * r + 7] for r in range(3)]
    (want_grad,) = torch.autograd.grad(sum((w * torch.from_numpy(c)).sum()
                                           for w, c in zip(windows, cot)), [xt])
    for r, got in enumerate(_load(tmp_path, 3)):
        assert torch.equal(got["y"], windows[r].detach())
        torch.testing.assert_close(got["grad"], want_grad[:, 3 * r:3 * r + 3], rtol=0,
                                   atol=1e-6)


def test_halo_exchange_refuses_a_shard_shorter_than_the_radius():
    from osu_dreamer_tpu_torch.ops.ring_attention import halo_exchange

    with pytest.raises(AssertionError, match=r"halo radius 2 exceeds the 1-frame local shard"):
        halo_exchange(torch.zeros(1, 1, 3), 2, None)


# -------------------------------------------------------------- denoiser ----


def _model(tree_np: dict, cfg: dict = TINY_DIFFUSION):
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
    from osu_dreamer_tpu_torch.models.inference.artifact import from_flax_params
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    model = DiffusionModel(dataclass_from_dict(DiffusionModelArgs, cfg), torch.float32)
    model.load_state_dict(from_flax_params(tree_np, model))
    return model


def _jax_case(seed: int, cfg: dict = TINY_DIFFUSION):
    """the tiny flax denoiser (``cfg``) with every leaf refilled, its batch
    (h, z, s, labels) and the step key's draws (t, x0)"""
    import jax

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu.models.diffusion.model import DiffusionModelArgs
    from osu_dreamer_tpu.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu.utils import dataclass_from_dict
    from test_torch_modules import KEY, fill_tree

    rng = np.random.default_rng(seed)
    batch = (rng.random((B, L, 16), dtype=np.float32),
             rng.standard_normal((B, L, 6)).astype(np.float32),
             rng.standard_normal((B, 8)).astype(np.float32),
             rng.uniform(0, 10, (B, 5)).astype(np.float32))
    jm = JDiff(dataclass_from_dict(DiffusionModelArgs, cfg), jax.numpy.float32)
    tree = fill_tree(jax.jit(jm.init)(KEY, batch[0], batch[2], batch[1]), seed)
    step_rng = jax.random.PRNGKey(seed)
    k_t, k_noise = jax.random.split(step_rng)
    t = np.asarray(stratified_logit_normal_t(k_t, B))
    x0 = np.asarray(jax.random.normal(k_noise, (B, L, 6), jax.numpy.float32))
    tree_np = jax.tree.map(np.asarray, tree)
    return jm, tree, tree_np, batch, step_rng, t, x0


def _forward_rank(out: str, tree_np: dict, h, s, xt, x0) -> None:
    par = _par({"sp": 2}, 2)
    model = _model(tree_np)
    span = L // 2
    sl = slice(par.sp_rank * span, (par.sp_rank + 1) * span)
    hs, xts = (torch.from_numpy(np.ascontiguousarray(a[:, sl])) for a in (h, xt))
    with torch.no_grad():
        u, v = model(hs, torch.from_numpy(s), xts, sp=par.sp_group)
        z = model.sample(hs, torch.from_numpy(s), 3, x0=torch.from_numpy(x0), sp=par.sp_group)
    _save(out, par.rank, u=u, v=v, z=z)


def test_sp_denoiser_forward_and_sample_match_jax(tmp_path):
    """sp 2: u on every rank and each rank's span of v equal the JAX
    unsharded forward; ``sample`` with the global noise injected gives each
    rank its span of the JAX sampler's chart for that noise (the JAX
    ``test_sp_model_and_train_step_match_single_device`` tolerances)"""
    import jax
    import jax.numpy as jnp

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff

    jm, tree, tree_np, (h, xt, s, _), _, _, _ = _jax_case(7)
    u_ref, v_ref = jax.jit(jm.apply)(tree, h, s, xt)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (B, L, 6), jnp.float32))
    z_ref = jax.jit(lambda p: jm.apply(p, h, s, jax.random.PRNGKey(9), 3,
                                       method=JDiff.sample))(tree)
    spawn(_forward_rank, str(tmp_path), tree_np, h, s, xt, x0)
    for r, got in enumerate(_load(tmp_path, 2)):
        sl = slice(r * L // 2, (r + 1) * L // 2)
        np.testing.assert_allclose(got["u"].numpy(), np.asarray(u_ref), rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(got["v"].numpy(), np.asarray(v_ref)[:, sl], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(got["z"].numpy(), np.asarray(z_ref)[:, sl], rtol=2e-4,
                                   atol=2e-4)


def _step_rank(out: str, args: dict, tree_np: dict, batch, t, x0,
               cfg: dict = TINY_DIFFUSION) -> None:
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, init_diffusion_training, step_gradients,
    )
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModelArgs
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    ranks = 2 * args.get("dp", 1)
    par = _par({"sp": 2}, ranks)
    local = par.shard_batch(LatentBatch(*map(torch.from_numpy, batch)), seq_fields=(0, 1))
    t, x0 = torch.from_numpy(t), torch.from_numpy(x0)
    targs = DiffusionTrainArgs()
    model = _model(tree_np, cfg)
    metrics, grads = step_gradients(model, local, targs, None, t, x0, par)
    state, train_step = init_diffusion_training(
        dataclass_from_dict(DiffusionModelArgs, cfg), targs, 0, "cpu", torch.float32, par)
    state.model.load_state_dict(model.state_dict())
    state.ema_model.load_state_dict(model.state_dict())
    train_step(state, local, t, x0)
    names = [k for k, _ in model.named_parameters()]
    _save(out, par.rank, metrics=metrics, grads=dict(zip(names, grads)),
          params=[p.detach() for p in state.model.parameters()])


@pytest.mark.parametrize("dp", [1, 2])
def test_sp_train_step_matches_jax(tmp_path, dp):
    """one step at (data=dp, sp=2): the loss terms on every rank equal the
    JAX unsharded ``diffusion_loss`` (1e-5 relative) and the gradients
    averaged over the ranks its gradients (2e-5 of the largest, the
    tolerance of tests/test_torch_train.py), with the JAX draws injected at
    the global shape; the ranks' parameters after the step equal bit for
    bit"""
    import jax

    from osu_dreamer_tpu.models.diffusion.train import DiffusionTrainArgs as JArgs
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu_torch.models.inference.artifact import _flatten

    jm, tree, tree_np, batch, step_rng, t, x0 = _jax_case(11 + dp)
    (_, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, step_rng, JBatch(*batch), JArgs()), has_aux=True))(tree)
    spawn(_step_rank, str(tmp_path), {"dp": dp}, tree_np, batch, t, x0, ranks=2 * dp)
    ranks = _load(tmp_path, 2 * dp)
    want = {k: np.asarray(v) for k, v in _flatten(grads_j["params"]).items()}
    gmax = max(np.abs(g).max() for g in want.values())
    for got in ranks:
        for name in ("loss", "osl", "del", "u_mape"):
            np.testing.assert_allclose(got["metrics"][name].numpy(), np.asarray(aux_j[name]),
                                       rtol=1e-5, err_msg=name)
        for key, w in want.items():
            np.testing.assert_allclose(got["grads"][key].numpy(), w, atol=2e-5 * gmax,
                                       err_msg=key)
        for p, p0 in zip(got["params"], ranks[0]["params"]):
            assert torch.equal(p, p0)


# ------------------------------------------------------------------- fit ----


def _record(path: str, step: int, metrics: dict) -> None:
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    with open(Path(path) / f"losses{rank}.jsonl", "a") as f:
        f.write(json.dumps([step, float(metrics["loss"])]) + "\n")


def test_fit_denoiser_sequence_parallel_from_config(tmp_path, capsys, monkeypatch):
    """``parallel: {sp: 2}`` over two devices trains with the window sharded:
    every rank logs the single-process run's losses step for step (1e-5
    relative), the replicas end equal, rank 0 writes both checkpoints; the
    JAX refusals of the sp branch are kept"""
    from osu_dreamer_tpu_torch.models.diffusion.fit import run
    from osu_dreamer_tpu_torch.parallel import distributed
    from test_torch_parallel_dp import _fit_config

    monkeypatch.setattr(distributed, "COLLECTIVE_TIMEOUT_S", COLLECTIVE_S)
    (tmp_path / "sp").mkdir()
    (tmp_path / "one").mkdir()
    run(_fit_config(tmp_path, "runs/sp", 3, {"sp": 2}), device="cpu", devices=["cpu"] * 2,
        on_step=functools.partial(_record, str(tmp_path / "sp")))
    assert "[parallel] sequence-parallel: (data=1, sp=2) mesh" in capsys.readouterr().out
    run(_fit_config(tmp_path, "runs/one", 3, {"dp": 1}), device="cpu",
        on_step=functools.partial(_record, str(tmp_path / "one")))
    want = [json.loads(line) for line in (tmp_path / "one" / "losses0.jsonl").open()]
    for r in range(2):
        got = [json.loads(line) for line in (tmp_path / "sp" / f"losses{r}.jsonl").open()]
        assert [s for s, _ in got] == [1, 2, 3]
        np.testing.assert_allclose([x for _, x in got], [x for _, x in want], rtol=1e-5)
    for ckpt in ("best", "last"):
        assert (tmp_path / "runs" / "sp" / ckpt / "state.pt").exists()

    cfg = _fit_config(tmp_path, "runs/bad", 1, {"sp": 2})
    bad = [({"seq_len": 25}, "data.seq_len 25 must divide over parallel.sp=2"),
           ({"seq_len": 2}, r"seq_len/sp = 1 frames per shard is below the 2-frame conv radius")]
    for data, match in bad:
        with pytest.raises(ValueError, match=match):
            run({**cfg, "data": {**cfg["data"], **data}}, device="cpu", devices=["cpu"] * 2)
    backbone = {**cfg["model"]["backbone"], "dropout": 0.1}
    with pytest.raises(ValueError, match="per-shard dropout masks would be correlated"):
        run({**cfg, "model": {**cfg["model"], "backbone": backbone}}, device="cpu",
            devices=["cpu"] * 2)
