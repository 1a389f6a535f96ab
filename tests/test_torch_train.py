"""Denoiser training in the port (osu_dreamer_tpu_torch: models/diffusion/
{train,fit}.py, train/, nn/schedule.py) against the JAX package on the CPU.

The whole-step test transplants a flax parameter tree whose EVERY leaf is
refilled from a numpy seed (``fill_tree``), draws t and x0 the way the JAX
loss draws them and injects them into the port, and compares one step in f32:
the loss terms, every gradient leaf, the parameters after clip + AdamW and
the EMA. Both sides compute in f32 and differ only in the summation order of
their products; the tolerances below leave room for that.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.data.synth import write_latent_corpus
from osu_dreamer_tpu_torch.models.inference.artifact import _flatten, from_flax_params
from test_torch_modules import KEY, N, T, fill_tree

torch.set_num_threads(1)
F32 = jnp.float32

TINY_MODEL = dict(emb_dim=6, a_dim=16, style_dim=8, global_cond_dim=32, backbone_dim=128,
                  u_head_dim=16, backbone=dict(depth=2, expand=2, head_dim=64, n_heads=2,
                                               radius=2))


def _args(package: str, **opt):
    if package == "jax":
        from osu_dreamer_tpu.models.diffusion.model import DiffusionModelArgs
        from osu_dreamer_tpu.models.diffusion.train import DiffusionTrainArgs
        from osu_dreamer_tpu.utils import dataclass_from_dict
    else:
        from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModelArgs
        from osu_dreamer_tpu_torch.models.diffusion.train import DiffusionTrainArgs
        from osu_dreamer_tpu_torch.utils import dataclass_from_dict
    train = {"opt": {"schedule": {"warmup_init": 0.3, "warmup_steps": 10, "decay_start": 20},
                     **opt}}
    return (dataclass_from_dict(DiffusionModelArgs, TINY_MODEL),
            dataclass_from_dict(DiffusionTrainArgs, train))


# ---------------------------------------------------------------- copies ----


def test_config_copy_and_args_match_jax():
    from osu_dreamer_tpu.models.diffusion import fit as jfit
    from osu_dreamer_tpu.models.diffusion import train as jtrain
    from osu_dreamer_tpu.nn.schedule import LRScheduleArgs as JSched
    from osu_dreamer_tpu.train.loop import FitArgs as JFit
    from osu_dreamer_tpu.train.state import OptimizerArgs as JOpt
    from osu_dreamer_tpu_torch.models.diffusion import fit as tfit
    from osu_dreamer_tpu_torch.models.diffusion import train as ttrain
    from osu_dreamer_tpu_torch.nn.schedule import LRScheduleArgs as TSched
    from osu_dreamer_tpu_torch.train.loop import FitArgs as TFit
    from osu_dreamer_tpu_torch.train.state import OptimizerArgs as TOpt

    jconfig = Path(jfit.__file__).parent / "config.yml"
    assert tfit.CONFIG.read_bytes() == jconfig.read_bytes()
    pairs = [(ttrain.DiffusionTrainArgs, jtrain.DiffusionTrainArgs),
             (tfit.DiffusionDataArgs, jfit.DiffusionDataArgs), (TOpt, JOpt), (TSched, JSched)]
    for t, j in pairs:
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), t.__name__
    # the loop's options, minus the JAX loop's multi-host ones
    jfields = {f.name: f.default for f in dataclasses.fields(JFit)}
    assert {f.name: f.default for f in dataclasses.fields(TFit)} == jfields


def test_lr_schedule_matches_jax():
    from osu_dreamer_tpu.nn.schedule import LRScheduleArgs as JSched
    from osu_dreamer_tpu.nn.schedule import lr_at as jlr_at
    from osu_dreamer_tpu.nn.schedule import make_lr_schedule as jmake
    from osu_dreamer_tpu_torch.nn.schedule import LRScheduleArgs, lr_at, make_lr_schedule

    for kw in (dict(warmup_init=0.3, warmup_steps=1000, decay_start=30000), {},
               dict(warmup_init=0.1, warmup_steps=5, decay_start=5)):
        jsched, tsched = jmake(3e-4, JSched(**kw)), make_lr_schedule(3e-4, LRScheduleArgs(**kw))
        for step in (0, 1, 4, 5, 6, 999, 1000, 1001, 30000, 30001, 123456):
            assert float(tsched(step)) == float(jsched(step)), (kw, step)
            assert lr_at(step, 3e-4, LRScheduleArgs(**kw)) == jlr_at(step, 3e-4, JSched(**kw))


def test_stratified_logit_normal_t_fills_every_stratum():
    """jax.random's draws cannot be reproduced: check the construction, one
    time per stratum of the normal CDF, as the JAX function builds it"""
    from osu_dreamer_tpu_torch.train.state import stratified_logit_normal_t

    for n in (1, 7, 128):
        t = stratified_logit_normal_t(n, torch.Generator().manual_seed(n), "cpu").double()
        u = torch.special.ndtr(torch.logit(t))
        assert sorted(torch.floor(u * n).long().tolist()) == list(range(n))


# ------------------------------------------------------------------ init ----


def test_init_params_matches_flax_init():
    """flax ``DiffusionModel.init`` and the port's ``init_params``, leaf by
    leaf: the same leaves exactly zero, one or constant, and each random
    leaf's std, in both packages, within sampling tolerance (4 standard
    errors of a sample std) of lecun_normal's 1/sqrt(fan_in), every value
    inside its truncation at 2 stds (flax's fans: fan_in of a (K, C) or
    (K, 1, C) conv kernel is K)"""
    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel as TDiff

    ja, _ = _args("jax")
    ta, _ = _args("torch")
    jtree = jax.jit(JDiff(ja, F32).init)(KEY, np.zeros((2, 24, 16)), np.zeros((2, 8)),
                                         np.zeros((2, 24, 6)))
    flax_leaves = {k: np.asarray(v) for k, v in _flatten(jtree["params"]).items()}
    model = TDiff(ta, torch.float32).init_params(torch.Generator().manual_seed(0))
    port = {k: N(v) for k, v in model.state_dict().items()}
    assert set(port) == set(flax_leaves)
    n_random = 0
    for key, want in flax_leaves.items():
        got = port[key]
        assert got.shape == want.shape, key
        if np.all(want == want.flat[0]):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        n_random += 1
        fan_in = int(np.prod(want.shape[:-1]))
        expected = fan_in**-0.5
        for leaf in (got, want):
            assert abs(leaf.std() - expected) <= 4 * expected / np.sqrt(2 * leaf.size), key
            # the truncation point: 2 stds of the normal before truncation
            assert np.abs(leaf).max() <= 2 * expected / 0.87962566103423978 * (1 + 1e-6), key
    assert n_random == 19  # 9 per backbone layer, 1 net-wide


# ------------------------------------------------------------ train step ----


@pytest.mark.parametrize("grad_clip", [1.0, 1e6])
def test_train_step_matches_jax(grad_clip):
    """one f32 step on transplanted params: loss terms, every gradient leaf,
    the params after clip + AdamW (the clip engaging at 1.0, not at 1e6) and
    the EMA (loss 1e-5 relative; gradients 2e-5 of the largest; params and
    EMA 5e-6 absolute, 5 % of the first step's learning rate 9e-5: Adam's
    first step is g / (|g| + 1e-8) times it, so an element whose gradient
    is near 1e-8 turns that gradient's rounding into a visible share of
    its step)"""
    import optax

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu.train.state import (
        create_train_state, ema_update, make_optimizer, stratified_logit_normal_t,
    )
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        LatentBatch, diffusion_loss, init_diffusion_training,
    )

    ja, jt = _args("jax", grad_clip=grad_clip)
    ta, tt = _args("torch", grad_clip=grad_clip)
    B, L = 4, 24
    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, L, 6)).astype(np.float32)
    batch_np = (rng.random((B, L, 16), dtype=np.float32), z,
                rng.standard_normal((B, 8)).astype(np.float32),
                rng.uniform(0, 10, (B, 5)).astype(np.float32))

    jm = JDiff(ja, F32)
    tree = fill_tree(jax.jit(jm.init)(KEY, batch_np[0], batch_np[2], z), 21)
    step_rng = jax.random.PRNGKey(5)
    tx = make_optimizer(jt.opt)

    @jax.jit
    def jax_step(tree):
        (_, aux), grads = jax.value_and_grad(
            lambda p: jloss(jm, p, step_rng, JBatch(*batch_np), jt), has_aux=True
        )(tree)
        jstate = create_train_state(tree, tx, KEY, with_ema=True)
        updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
        params = optax.apply_updates(jstate.params, updates)
        return aux, grads, params, ema_update(jstate.ema_params, params, jt.ema_decay)

    aux_j, grads_j, params_j, ema_j = jax_step(tree)
    # the draws diffusion_loss makes from step_rng, injected into the port
    k_t, k_noise = jax.random.split(step_rng)
    t = T(stratified_logit_normal_t(k_t, B))
    x0 = T(jax.random.normal(k_noise, z.shape, F32))

    state, train_step = init_diffusion_training(ta, tt, 0, "cpu", torch.float32)
    sd = from_flax_params(tree, state.model)
    state.model.load_state_dict(sd)
    state.ema_model.load_state_dict(sd)
    batch = LatentBatch(*map(T, batch_np))
    params = list(state.model.parameters())
    _, aux_t = diffusion_loss(state.model, batch, tt, t=t, x0=x0)
    grads_t = dict(zip([k for k, _ in state.model.named_parameters()],
                       torch.autograd.grad(aux_t["loss"], params)))
    for name in ("loss", "osl", "del", "u_mape"):
        np.testing.assert_allclose(N(aux_t[name]), np.asarray(aux_j[name]), rtol=1e-5,
                                   err_msg=name)
    gmax = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads_j))
    gnorm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                        for g in jax.tree.leaves(grads_j)))
    assert (gnorm > grad_clip) == (grad_clip == 1.0), gnorm  # the clip engages in one case
    for key, want in _flatten(grads_j["params"]).items():
        np.testing.assert_allclose(N(grads_t[key]), np.asarray(want), atol=2e-5 * gmax, err_msg=key)

    metrics = train_step(state, batch, t, x0)
    assert state.step == 1 and state.opt.count == 1
    np.testing.assert_allclose(N(metrics["loss"]), np.asarray(aux_j["loss"]), rtol=1e-5)
    for got_model, want_tree in ((state.model, params_j), (state.ema_model, ema_j)):
        got = got_model.state_dict()
        for key, want in _flatten(want_tree["params"]).items():
            np.testing.assert_allclose(N(got[key]), np.asarray(want), atol=5e-6, err_msg=key)


def test_train_step_matches_jax_with_fused_prologue(monkeypatch):
    """OSU_DREAMER_FUSED_PROLOGUE=1: one f32 step's loss terms and every
    gradient leaf, the port's attention prologues through ``film_qkv`` (its
    plain version on the CPU) against the JAX step through its Pallas
    prologue in interpret mode (tests/test_ops.py's monkeypatch); the
    tolerances of ``test_train_step_matches_jax``"""
    import osu_dreamer_tpu.nn.attention as jattn
    import osu_dreamer_tpu.ops.film_qkv as jfq
    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel as TDiff
    from osu_dreamer_tpu_torch.models.diffusion.train import LatentBatch, diffusion_loss
    from osu_dreamer_tpu_torch.nn import attention as tattn

    ja, jt = _args("jax")
    ta, tt = _args("torch")
    B, L = 4, 24
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, L, 6)).astype(np.float32)
    batch_np = (rng.random((B, L, 16), dtype=np.float32), z,
                rng.standard_normal((B, 8)).astype(np.float32),
                rng.uniform(0, 10, (B, 5)).astype(np.float32))
    jm = JDiff(ja, F32)
    tree = fill_tree(jax.jit(jm.init)(KEY, batch_np[0], batch_np[2], z), 22)
    step_rng = jax.random.PRNGKey(6)

    traced = []
    orig = jfq.film_qkv
    monkeypatch.setattr(jfq, "film_qkv", lambda *a: traced.append(1) or orig(*a, 16, True))
    monkeypatch.setattr(jattn, "_prologue_ok", lambda C_, F_: True)
    (_, aux_j), grads_j = jax.value_and_grad(
        lambda p: jloss(jm, p, step_rng, JBatch(*batch_np), jt), has_aux=True)(tree)
    assert len(traced) == 2  # one prologue per backbone layer

    k_t, k_noise = jax.random.split(step_rng)
    t = T(stratified_logit_normal_t(k_t, B))
    x0 = T(jax.random.normal(k_noise, z.shape, F32))
    monkeypatch.setenv("OSU_DREAMER_FUSED_PROLOGUE", "1")
    calls = []
    dispatch = tattn.film_qkv
    monkeypatch.setattr(tattn, "film_qkv", lambda *a: calls.append(1) or dispatch(*a))
    model = TDiff(ta, torch.float32)
    model.load_state_dict(from_flax_params(tree, model))
    _, aux_t = diffusion_loss(model, LatentBatch(*map(T, batch_np)), tt, t=t, x0=x0)
    assert len(calls) == 2
    grads_t = dict(zip([k for k, _ in model.named_parameters()],
                       torch.autograd.grad(aux_t["loss"], list(model.parameters()))))
    for name in ("loss", "osl", "del", "u_mape"):
        np.testing.assert_allclose(N(aux_t[name]), np.asarray(aux_j[name]), rtol=1e-5,
                                   err_msg=name)
    gmax = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads_j))
    for key, want in _flatten(grads_j["params"]).items():
        np.testing.assert_allclose(N(grads_t[key]), np.asarray(want), atol=2e-5 * gmax, err_msg=key)


# ------------------------------------------------------- fit and resume ----


def _fit_config(tmp: Path, run_dir: str, max_steps: int) -> dict:
    data = tmp / "data"
    if not data.exists():
        write_latent_corpus(data, 4, 2, 100, 16, 6, 8, seed=1)
    model = dict(TINY_MODEL, u_head_dim=8, global_cond_dim=16)
    return {
        "data": {"data_dir": str(data), "seq_len": 24, "batch_size": 4, "max_per_map": -1,
                 "shuffle_buffer": 8},
        "fit": {"run_dir": str(tmp / run_dir), "max_steps": max_steps, "log_every": 100,
                "save_last_every_s": 0.0},
        "train": {"val_batches": 2, "opt": {"schedule": {"warmup_init": 0.3,
                                                         "warmup_steps": 10}}},
        "model": model,
        "parallel": {"dp": -1, "tp": 1},
    }


def test_resume_is_exact(tmp_path):
    """4 straight steps equal 2 steps, a checkpoint, a resume and 2 more,
    bit for bit: params, optimizer moments, EMA, generator, step"""
    from osu_dreamer_tpu_torch.models.diffusion.fit import run

    straight = run(_fit_config(tmp_path, "a", 4), device="cpu")
    run(_fit_config(tmp_path, "b", 2), device="cpu")
    assert (tmp_path / "b" / "best" / "state.pt").exists()
    resumed = run(_fit_config(tmp_path, "b", 4), str(tmp_path / "b" / "last"), device="cpu")
    assert straight.step == resumed.step == 4
    a, b = straight.state_dict(), resumed.state_dict()
    for part in ("params", "ema_params"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])


def test_fit_denoiser_cli_and_refusals(tmp_path, capsys):
    """the CLI trains on the CPU when asked and writes both checkpoints; a
    CUDA run without a card, parallel blocks the one CPU device cannot hold
    (tensor parallelism among them) and dropout raise instead of running
    something else; a window beyond the fused-attention gate trains"""
    import json

    from osu_dreamer_tpu_torch.cli import main
    from osu_dreamer_tpu_torch.models.diffusion.fit import run

    cfg = _fit_config(tmp_path, "cli", 2)
    path = tmp_path / "cfg.yml"
    path.write_text(json.dumps(cfg))
    main(["fit-denoiser", "-c", str(path), "--device", "cpu"])
    assert "val/loss=" in capsys.readouterr().out
    for ckpt in ("last", "best"):
        meta = json.loads((tmp_path / "cli" / ckpt / "meta.json").read_text())
        assert meta["step"] == 2 and meta["hparams"]["model"] == cfg["model"]

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg, device="cuda")
    # the JAX refusals over one CPU device
    bad = [({"dp": 2}, ValueError, r"parallel.dp=2 but only 1 devices"),
           ({"tp": 2}, ValueError, r"1 devices not divisible by n_model=2"),
           ({"sp": 2}, ValueError, r"1 devices not divisible by parallel.sp=2")]
    for value, error, match in bad:
        with pytest.raises(error, match=match):
            run({**cfg, "parallel": value}, device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        run({**cfg, "model": {**cfg["model"], "backbone": {**cfg["model"]["backbone"],
                                                           "dropout": 0.1}}}, device="cpu")
    # a window past the fused-attention gate (2 x 64 heads at L 2100: L H D
    # 268,800) trains through the long attention, as in the JAX package
    long_data = tmp_path / "long_data"
    write_latent_corpus(long_data, 4, 2, 2100, 16, 6, 8, seed=2)
    state = run({**cfg, "data": {**cfg["data"], "data_dir": str(long_data), "seq_len": 2100},
                 "fit": {**cfg["fit"], "run_dir": str(tmp_path / "long"), "max_steps": 1}},
                device="cpu")
    assert state.step == 1
    assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())


def test_dropout_trains_in_neither_package(tmp_path):
    """``backbone.dropout > 0``: the JAX train step applies the model with
    ``train=True`` and no dropout PRNG, so flax raises InvalidRngError; the
    port's ``fit.run`` refuses before step 1, naming the finding"""
    import flax

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu_torch.models.diffusion.fit import run

    ja, jt = _args("jax")
    ja = dataclasses.replace(ja, backbone=dataclasses.replace(ja.backbone, dropout=0.1))
    B, L = 2, 8
    rng = np.random.default_rng(0)
    batch = JBatch(rng.random((B, L, 16), dtype=np.float32),
                   rng.standard_normal((B, L, 6)).astype(np.float32),
                   rng.standard_normal((B, 8)).astype(np.float32),
                   rng.uniform(0, 10, (B, 5)).astype(np.float32))
    jm = JDiff(ja, F32)
    params = jax.jit(jm.init)(KEY, batch.h, batch.s, batch.z)
    with pytest.raises(flax.errors.InvalidRngError, match="dropout"):
        jax.jit(jax.value_and_grad(lambda p: jloss(jm, p, KEY, batch, jt), has_aux=True))(params)
    cfg = _fit_config(tmp_path, "dropout", 1)
    with pytest.raises(NotImplementedError, match="InvalidRngError"):
        run({**cfg, "model": {**cfg["model"], "backbone": {**cfg["model"]["backbone"],
                                                           "dropout": 0.1}}}, device="cpu")
