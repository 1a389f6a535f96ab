"""Latent (stage-1) training in the port (osu_dreamer_tpu_torch: nn/pool.py,
nn/mmd.py, models/latent/{model,train,fit,encode}.py) against the JAX
package on the CPU, in f32.

Module and step tests transplant a flax parameter tree whose EVERY leaf is
refilled from a numpy seed (``fill_tree``): flax zero-initialises the FiLM
and skip-gate layers, and a comparison through zeros would be vacuous. The
step test draws the loss's seven random tensors the way the JAX loss draws
them and injects them into the port. Both sides compute in f32 and differ
only in the summation order of their products; each tolerance below leaves
room for that error to grow through the model's depth.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.data.synth import write_signal_corpus
from osu_dreamer_tpu_torch.models.inference.artifact import _conv_kernels, _flatten, from_flax_params
from test_torch_modules import KEY, TINY_LATENT, N, T, fill_tree, port, randn

torch.set_num_threads(1)
F32 = jnp.float32
L_TINY = 36  # two halves of 18 frames: 2 latents each at chunk 9


def _args(package: str, **opt):
    if package == "jax":
        from osu_dreamer_tpu.models.latent.model import LatentModelArgs
        from osu_dreamer_tpu.models.latent.train import LatentTrainArgs
        from osu_dreamer_tpu.utils import dataclass_from_dict
    else:
        from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs
        from osu_dreamer_tpu_torch.models.latent.train import LatentTrainArgs
        from osu_dreamer_tpu_torch.utils import dataclass_from_dict
    train = {"opt": {"lr": 1e-3, "schedule": {"warmup_init": 0.1, "warmup_steps": 10}, **opt}}
    return (dataclass_from_dict(LatentModelArgs, TINY_LATENT),
            dataclass_from_dict(LatentTrainArgs, train))


def _jax_tree(seed: int = 11):
    """the tiny flax LatentModel's full tree (``init_all``), every leaf refilled"""
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent

    ja, _ = _args("jax")
    jm = JLatent(ja, F32)
    tree = jax.jit(lambda: jm.init(KEY, jnp.zeros((2, 18, 72)), jnp.zeros((2, 18, 9)),
                                   method=JLatent.init_all))()
    return jm, fill_tree(tree, seed)


def _batch_np(B: int = 2, L: int = L_TINY, seed: int = 0):
    """(spec, chart, labels): spec in [0, 1], soft hit targets and a cursor
    in [0, 1], labels in [0, 10]"""
    rng = np.random.default_rng(seed)
    return (rng.random((B, L, 72), dtype=np.float32), rng.random((B, L, 9), dtype=np.float32),
            rng.uniform(0, 10, (B, 5)).astype(np.float32))


# ---------------------------------------------------------------- copies ----


def test_latent_config_copy_and_args_match_jax():
    from osu_dreamer_tpu.models.latent import fit as jfit
    from osu_dreamer_tpu.models.latent import train as jtrain
    from osu_dreamer_tpu_torch.models.latent import encode as tencode
    from osu_dreamer_tpu_torch.models.latent import fit as tfit
    from osu_dreamer_tpu_torch.models.latent import train as ttrain

    assert tfit.CONFIG.read_bytes() == (Path(jfit.__file__).parent / "config.yml").read_bytes()
    for t, j in ((ttrain.LatentTrainArgs, jtrain.LatentTrainArgs),
                 (tfit.LatentDataArgs, jfit.LatentDataArgs)):
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), t.__name__
    assert ttrain.LOSS_COMPONENTS == jtrain.LOSS_COMPONENTS
    np.testing.assert_array_equal(ttrain.LOSS_WEIGHTS, jtrain.LOSS_WEIGHTS)
    assert ttrain.LOSS_WEIGHTS[-1] == 6  # the label weight
    assert tfit.BUCKET_CHUNKS == jfit.BUCKET_CHUNKS
    assert tencode.BUCKET_CHUNKS == 64  # cli/commands.py encode_latents: bucket = chunk * 64


def test_training_helpers_match_jax():
    from osu_dreamer_tpu.models.latent import train as jtrain
    from osu_dreamer_tpu_torch.models.latent import train as ttrain

    x, s = randn(0, 3, 12, 5), randn(1, 6, 4)
    np.testing.assert_array_equal(N(ttrain._split_halves(T(x))), np.asarray(jtrain._split_halves(x)))
    np.testing.assert_array_equal(N(ttrain._swap_style_pairs(T(s))),
                                  np.asarray(jtrain._swap_style_pairs(s)))
    t = np.array([0.0, 1e-7, 0.3, 0.5, 0.999, 1.0], np.float32)
    np.testing.assert_allclose(N(ttrain._binary_entropy(T(t))), np.asarray(jtrain._binary_entropy(t)),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- modules ----


def test_attn_pool_matches_jax():
    """f32 softmax over L, the per-head weighted sum, the output projection
    (1e-5: one f32 layer)"""
    from osu_dreamer_tpu.nn.pool import AttnPool as JPool
    from osu_dreamer_tpu_torch.nn.pool import AttnPool as TPool

    x = randn(0, 3, 11, 16)
    jm = JPool(8, 4, 3, F32)
    tree = fill_tree(jm.init(KEY, x), 2)
    tm = port(TPool(16, 8, 4, 3, torch.float32), tree)
    assert set(tm.state_dict()) == {f"{n}.{p}" for n in ("scores", "values", "out")
                                    for p in ("kernel", "bias")}
    np.testing.assert_allclose(N(tm(T(x))), np.asarray(jm.apply(tree, x)), atol=1e-5, rtol=1e-5)


def test_mmd_imq_matches_jax():
    """the value and its gradient in the sample, in f32 (also from bf16
    inputs, which both sides upcast first; 1e-5 relative)"""
    from osu_dreamer_tpu.nn.mmd import mmd_imq as jmmd
    from osu_dreamer_tpu_torch.nn.mmd import mmd_imq as tmmd

    z, prior = randn(0, 8, 6, scale=1.5), randn(1, 8, 6)
    want, want_grad = jax.value_and_grad(jmmd)(z, prior)
    zt = T(z).requires_grad_()
    got = tmmd(zt, T(prior))
    (got_grad,) = torch.autograd.grad(got, zt)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(N(got_grad), np.asarray(want_grad), rtol=1e-5, atol=1e-7)
    zb = T(z).to(torch.bfloat16)
    np.testing.assert_allclose(N(tmmd(zb, T(prior))),
                               np.asarray(jmmd(jnp.asarray(z, jnp.bfloat16), prior)), rtol=1e-5)


def test_encode_chart_and_training_forward_match_jax():
    """``encode_chart`` (z and s RMS-normalised), the training forward
    (logits, labels) and ``decode`` given ``spec=`` (1e-4: the chart and
    audio encoders and the decoder, about 20 f32 layers deep)"""
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent
    from osu_dreamer_tpu_torch.models.latent.model import LatentModel as TLatent

    jm, tree = _jax_tree()
    ta = _args("torch")[0]
    tm = port(TLatent(ta, torch.float32), tree)
    spec, chart, _ = _batch_np(3, 36)
    z_j, s_j = jm.apply(tree, chart, method=JLatent.encode_chart)
    z_t, s_t = tm.encode_chart(T(chart))
    np.testing.assert_allclose(N(z_t), np.asarray(z_j), atol=1e-4)
    np.testing.assert_allclose(N(s_t), np.asarray(s_j), atol=1e-4)
    np.testing.assert_allclose(N(z_t.square().mean(-1)), 1.0, atol=1e-4)

    z, s = randn(4, 3, 4, 4), randn(5, 3, 8)
    logits_j, lab_j = jm.apply(tree, spec, z, s)
    logits_t, lab_t = tm(T(spec), T(z), T(s))
    np.testing.assert_allclose(N(logits_t), np.asarray(logits_j), atol=1e-4)
    np.testing.assert_allclose(N(lab_t), np.asarray(lab_j), atol=1e-4)
    chart_j, clip_j = jm.apply(tree, z, s, spec=spec, method=JLatent.decode)
    chart_t, clip_t = tm.decode(T(z), T(s), spec=T(spec))
    np.testing.assert_allclose(N(chart_t), np.asarray(chart_j), atol=1e-4)
    np.testing.assert_allclose(N(clip_t), np.asarray(clip_j), atol=1e-4)
    with pytest.raises(ValueError, match="multiple of 9"):
        tm.encode_chart(T(chart[:, :20]))
    with pytest.raises(ValueError, match="spec or skips"):
        tm.decode_logits(T(z), T(s))


# ------------------------------------------------------------------ init ----


def test_latent_init_params_matches_flax_init():
    """flax ``LatentModel.init`` (``init_all``) and the port's
    ``init_params``, leaf by leaf: the same leaves exactly zero or constant
    (every bias, the FiLM and skip-gate layers, the unit gains, the
    block-norm gains 1e-3), and each random leaf's std, in both packages,
    within sampling tolerance (4 standard errors) of lecun_normal's
    1/sqrt(fan_in) with flax's fans (a conv kernel (kh, kw, in, out) has
    fan_in kh * kw * in), every value inside its truncation at 2 stds"""
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent
    from osu_dreamer_tpu_torch.models.latent.model import LatentModel as TLatent

    ja, ta = _args("jax")[0], _args("torch")[0]
    jtree = jax.jit(lambda: JLatent(ja, F32).init(KEY, jnp.zeros((2, 18, 72)),
                                                  jnp.zeros((2, 18, 9)),
                                                  method=JLatent.init_all))()
    flax_leaves = {k: np.asarray(v) for k, v in _flatten(jtree["params"]).items()}
    model = TLatent(ta, torch.float32).init_params(torch.Generator().manual_seed(0))
    conv = _conv_kernels(model)
    port_leaves = {k: N(v.permute(2, 3, 1, 0) if k in conv else v)
                   for k, v in model.state_dict().items()}
    assert set(port_leaves) == set(flax_leaves)
    assert conv == {"spec_stem.c1.kernel", "spec_stem.c2.kernel"}
    for i in range(ta.n_downs):
        gate = port_leaves[f"decoder.mix{i}.gate.kernel"]
        assert not gate.any() and not port_leaves[f"decoder.mix{i}.gate.bias"].any()
    n_random = 0
    for key, want in flax_leaves.items():
        got = port_leaves[key]
        assert got.shape == want.shape, key
        if np.all(want == want.flat[0]):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        n_random += 1
        expected = int(np.prod(want.shape[:-1])) ** -0.5
        for leaf in (got, want):
            assert abs(leaf.std() - expected) <= 4 * expected / np.sqrt(2 * leaf.size), key
            assert np.abs(leaf).max() <= 2 * expected / 0.87962566103423978 * (1 + 1e-6), key
    # chart stem 1, each U-Net encoder 2 x (3 SwiGLU + 1 downsample conv),
    # spec stem 3, style stack 3, style pool 3, temporal stack 3, temporal
    # and emb proj 2, decoder 2 x (up conv + skip proj + 3 SwiGLU), head 1,
    # label MLP 2
    assert n_random == 44


# ------------------------------------------------------------ train step ----


def _jax_draws(step_rng, n: int, s_dim: int, l: int, e_dim: int):
    """the seven draws the JAX ``latent_loss`` makes from its step key"""
    k_prior, k_sn, k_zn, k_smask, k_srepl, k_span, k_start = jax.random.split(step_rng, 7)
    return (jax.random.normal(k_prior, (n, s_dim)), jax.random.normal(k_sn, (n, s_dim), F32),
            jax.random.normal(k_zn, (n, l, e_dim), F32), jax.random.uniform(k_smask, (n,)),
            jax.random.normal(k_srepl, (n, s_dim), F32), jax.random.uniform(k_span, (n,)),
            jax.random.uniform(k_start, (n,)))


@pytest.mark.parametrize("grad_clip", [1.0, 1e6])
def test_latent_train_step_matches_jax(grad_clip):
    """two f32 steps on transplanted params with the draws injected: the 11
    loss components and ``s_reg`` (1e-5 relative), every gradient leaf of
    the first step (2e-5 of the largest), the params after clip + AdamW
    (the clip engaging at 1.0, not at 1e6) and ``loss_ema`` /
    ``loss_ema_ready`` after each step. The first step normalises the
    components by themselves, the second by the EMA. Params 5e-6 absolute,
    5 % of the first step's learning rate 1e-4: Adam's first step is
    g / (|g| + 1e-8) times it, so an element whose gradient is near 1e-8
    turns that gradient's rounding into a visible share of its step."""
    from osu_dreamer_tpu.models.latent import train as jtrain
    from osu_dreamer_tpu.train.state import create_train_state, make_optimizer
    from osu_dreamer_tpu_torch.models.latent.train import (
        LOSS_COMPONENTS, LOSS_WEIGHTS, Batch, LatentDraws, init_latent_training, latent_loss,
    )

    ja, jt = _args("jax", grad_clip=grad_clip)
    ta, tt = _args("torch", grad_clip=grad_clip)
    jm, tree = _jax_tree()
    batch_np = _batch_np()
    jbatch = jtrain.Batch(*map(jnp.asarray, batch_np))
    tx = make_optimizer(jt.opt)
    # the JAX step donates its state: it gets its own copy of the tree, and
    # whatever is read after a step is copied to numpy first
    tree = jax.tree.map(np.asarray, tree)
    jstate = create_train_state(jax.tree.map(jnp.array, tree), tx, jax.random.PRNGKey(7),
                                with_ema=False, n_loss_components=len(LOSS_COMPONENTS))
    jstep = jtrain.make_train_step(jm, tx, jt)
    n, l = 2 * batch_np[0].shape[0], L_TINY // 2 // ta.chunk_size

    def step_draws(state_rng):
        return _jax_draws(jax.random.split(jnp.asarray(state_rng))[1], n, ta.style_dim, l, ta.emb_dim)

    # the first step's gradient, as the JAX step forms it
    step_rng = jax.random.split(jstate.rng)[1]

    def jloss(params):
        comps, aux, s_reg = jtrain.latent_loss(jm, params, step_rng, jbatch, jt, True)
        total = (LOSS_WEIGHTS * comps / jnp.clip(jax.lax.stop_gradient(comps), 1e-8)).sum()
        return total + jt.s_reg_weight * s_reg, aux

    (_, aux_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    draws1 = LatentDraws(*map(T, step_draws(jstate.rng)))
    rngs, jstates, jaux = [np.asarray(jstate.rng)], [], []
    for _ in range(2):
        jstate, aux = jstep(jstate, jbatch)
        jstates.append(jax.tree.map(np.asarray, (jstate.params, jstate.loss_ema,
                                                  jstate.loss_ema_ready)))
        jaux.append(jax.tree.map(np.asarray, aux))
        rngs.append(np.asarray(jstate.rng))

    state, train_step = init_latent_training(ta, tt, 0, "cpu", torch.float32)
    state.model.load_state_dict(from_flax_params(tree, state.model))
    batch = Batch(*map(T, batch_np))

    comps, aux_t, s_reg = latent_loss(state.model, batch, tt, draws=draws1)
    total = (torch.from_numpy(LOSS_WEIGHTS) * comps / comps.detach().clamp_min(1e-8)).sum()
    total = total + tt.s_reg_weight * s_reg
    names = [k for k, _ in state.model.named_parameters()]
    grads_t = dict(zip(names, torch.autograd.grad(total, list(state.model.parameters()),
                                                  materialize_grads=True)))
    for name in (*LOSS_COMPONENTS, "s_reg"):
        np.testing.assert_allclose(N(aux_t[name]), np.asarray(aux_j[name]), rtol=1e-5,
                                   err_msg=name)
    gmax = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads_j))
    gnorm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                        for g in jax.tree.leaves(grads_j)))
    assert (gnorm > grad_clip) == (grad_clip == 1.0), gnorm  # the clip engages in one case
    conv = _conv_kernels(state.model)
    for key, want in _flatten(grads_j["params"]).items():
        got = grads_t[key].permute(2, 3, 1, 0) if key in conv else grads_t[key]
        np.testing.assert_allclose(N(got), np.asarray(want), atol=2e-5 * gmax, err_msg=key)

    for i in range(2):
        metrics = train_step(state, batch, LatentDraws(*map(T, step_draws(rngs[i]))))
        assert state.step == i + 1 and state.opt.count == i + 1
        for name in (*LOSS_COMPONENTS, "s_reg", "loss"):
            np.testing.assert_allclose(N(metrics[name]), np.asarray(jaux[i][name]), rtol=1e-5,
                                       err_msg=f"step {i + 1} {name}")
        params_j, ema_j, ready_j = jstates[i]
        np.testing.assert_allclose(N(state.loss_ema), ema_j, rtol=1e-5)
        assert bool(state.loss_ema_ready) and bool(ready_j)
        got = state.model.state_dict()
        for key, want in _flatten(params_j["params"]).items():
            g = got[key].permute(2, 3, 1, 0) if key in conv else got[key]
            # the softmax over L is blind to a per-head shift, so the true
            # gradient of the score bias is zero and Adam turns each side's
            # rounding residue into a step of up to the learning rate (1e-4),
            # of either sign: the two may lie 2e-4 apart per step
            atol = 2e-4 * (i + 1) if key == "style_pool.scores.bias" else 5e-6 * (i + 1)
            np.testing.assert_allclose(N(g), np.asarray(want), atol=atol,
                                       err_msg=f"step {i + 1} {key}")


def test_latent_loss_draws_from_the_state_generator():
    """without injected draws the loss draws from the generator: the same
    seed gives the same components, another seed others; eval mode
    (``train=False``) adds no noise and masks nothing"""
    from osu_dreamer_tpu_torch.models.latent.model import LatentModel
    from osu_dreamer_tpu_torch.models.latent.train import Batch, latent_loss

    ta, tt = _args("torch")
    model = LatentModel(ta, torch.float32).init_params(torch.Generator().manual_seed(0))
    batch = Batch(*map(T, _batch_np()))
    runs = [latent_loss(model, batch, tt, torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    evals = [latent_loss(model, batch, tt, torch.Generator().manual_seed(s), train=False)
             for s in (1, 2)]
    # only the MMD's prior sample, outside the components, still differs
    assert torch.equal(evals[0][0], evals[1][0]) and not torch.equal(evals[0][2], evals[1][2])


# ------------------------------------------------------- fit and resume ----


def _fit_config(tmp: Path, run_dir: str, max_steps: int) -> dict:
    data = tmp / "data"
    if not data.exists():
        write_signal_corpus(data, 4, 2, 120, seed=1)
    return {
        "data": {"data_dir": str(data), "seq_len": L_TINY, "batch_size": 2, "max_per_map": -1,
                 "shuffle_buffer": 4},
        "fit": {"run_dir": str(tmp / run_dir), "max_steps": max_steps, "log_every": 100,
                "save_last_every_s": 0.0, "monitor": "eval/score", "monitor_mode": "max"},
        "train": {"opt": {"lr": 1e-3, "schedule": {"warmup_init": 0.1, "warmup_steps": 10}}},
        "model": TINY_LATENT,
        "parallel": {"dp": -1, "tp": 1},
    }


def test_latent_resume_is_exact(tmp_path):
    """4 straight steps equal 2 steps, a checkpoint, a resume and 2 more,
    bit for bit: params, optimizer moments, generator, step, loss EMA and
    its ready flag (no EMA model in this stage)"""
    from osu_dreamer_tpu_torch.models.latent.fit import run

    straight = run(_fit_config(tmp_path, "a", 4), device="cpu")
    run(_fit_config(tmp_path, "b", 2), device="cpu")
    resumed = run(_fit_config(tmp_path, "b", 4), str(tmp_path / "b" / "last"), device="cpu")
    assert straight.step == resumed.step == 4
    a, b = straight.state_dict(), resumed.state_dict()
    assert a["ema_params"] is None and b["ema_params"] is None
    for key in a["params"]:
        assert torch.equal(a["params"][key], b["params"][key]), key
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert torch.equal(x, y)
    for key in ("generator", "loss_ema", "loss_ema_ready"):
        assert torch.equal(a[key], b[key]), key
    assert bool(a["loss_ema_ready"]) and not torch.equal(a["loss_ema"], torch.ones(11))


def test_fit_latent_and_encode_latents_cli(tmp_path, capsys):
    """``fit-latent`` on the CPU writes both checkpoints (monitor
    eval/score); ``encode-latents`` from the best one writes h.npy and
    <id>.latent.npz that the port's latent pipeline reads; ``--force``
    re-encodes; a CUDA run without a card, parallelism and a seq_len off
    the 2 * chunk grid raise"""
    from osu_dreamer_tpu_torch.cli import main
    from osu_dreamer_tpu_torch.data.pipeline import hold_out_mapsets, latent_windows
    from osu_dreamer_tpu_torch.models.latent.encode import encode_latents
    from osu_dreamer_tpu_torch.models.latent.fit import run

    cfg = _fit_config(tmp_path, "cli", 2)
    path = tmp_path / "cfg.yml"
    path.write_text(json.dumps(cfg))
    main(["fit-latent", "-c", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "eval/score=" in out and "*best*" in out
    for ckpt in ("last", "best"):
        meta = json.loads((tmp_path / "cli" / ckpt / "meta.json").read_text())
        assert meta["step"] == 2 and meta["hparams"]["model"] == cfg["model"]
    assert np.isfinite(json.loads((tmp_path / "cli" / "best" / "meta.json").read_text())["metric"])

    data = Path(cfg["data"]["data_dir"])
    args = ["encode-latents", "--latent-ckpt-path", str(tmp_path / "cli" / "best"),
            "--data-dir", str(data), "--device", "cpu"]
    main(args)
    assert "encoded 8 maps" in capsys.readouterr().out
    sets, _ = hold_out_mapsets(data, "*.latent.npz", 0, 0.0)
    samples = list(latent_windows(sets, None))
    assert len(samples) == 8
    n_latent = -(-120 // 9)
    for sample in samples:
        assert sample.h.shape == (n_latent, 16) and sample.z.shape == (n_latent, 4)
        assert sample.s.shape == (8,) and sample.labels.shape == (5,)
        np.testing.assert_allclose(sample.z.astype(np.float64) ** 2 @ np.full(4, 0.25), 1.0,
                                   rtol=1e-4)
    main(args)
    assert "encoded 0 maps" in capsys.readouterr().out  # kept without --force
    main(args + ["--force"])
    assert "encoded 8 maps" in capsys.readouterr().out

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            encode_latents(tmp_path / "cli" / "best", data, device="cuda")
    # the JAX refusals over one CPU device
    bad = [({"dp": 2}, ValueError, r"parallel.dp=2 but only 1 devices"),
           ({"tp": 2}, ValueError, r"1 devices not divisible by n_model=2")]
    for value, error, match in bad:
        with pytest.raises(error, match=match):
            run({**cfg, "parallel": value}, device="cpu")
    with pytest.raises(ValueError, match="parallel.sp"):
        run({**cfg, "parallel": {"sp": 2}}, device="cpu")
    with pytest.raises(ValueError, match="multiple of 18"):
        run({**cfg, "data": {**cfg["data"], "seq_len": 27}}, device="cpu")
    with pytest.raises(FileNotFoundError, match="no pre-processed maps"):
        encode_latents(tmp_path / "cli" / "best", tmp_path / "cli", device="cpu")


def test_encode_latents_matches_jax(tmp_path):
    """encode-latents on a checkpoint holding a transplanted flax tree: h, z
    and s equal the JAX model's ``encode_audio`` / ``encode_chart`` on the
    same bucket-padded inputs (the spectrogram dequantised from uint8 as
    ``read_spec`` does), cut to ceil(L / chunk) (1e-4, as the modules)"""
    from osu_dreamer_tpu.audio.io import read_spec
    from osu_dreamer_tpu.data.pipeline import pad_to_multiple
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent
    from osu_dreamer_tpu.signal.encoding import read_beatmap
    from osu_dreamer_tpu_torch.models.latent.encode import encode_latents
    from osu_dreamer_tpu_torch.models.latent.train import init_latent_training
    from osu_dreamer_tpu_torch.train.checkpoint import save_train_checkpoint

    jm, tree = _jax_tree(12)
    ta, tt = _args("torch")
    state, _ = init_latent_training(ta, tt, 0, "cpu", torch.float32)
    state.model.load_state_dict(from_flax_params(tree, state.model))
    save_train_checkpoint(tmp_path / "ckpt", state, {"model": TINY_LATENT, "train": {}})
    data = write_signal_corpus(tmp_path / "data", 2, 2, 100, seed=3)
    assert encode_latents(tmp_path / "ckpt", data, device="cpu") == 4

    bucket, n_latent = 9 * 64, -(-100 // 9)
    for mapset in sorted(data.iterdir()):
        with open(mapset / "spec.npy", "rb") as f:
            spec = pad_to_multiple(read_spec(f).T, bucket)[None]
        _, h = jm.apply(tree, spec, method=JLatent.encode_audio)
        np.testing.assert_allclose(np.load(mapset / "h.npy"), np.asarray(h)[0, :n_latent],
                                   atol=1e-4)
        for map_file in sorted(mapset.glob("*.map.npy")):
            with open(map_file, "rb") as f:
                chart, labels = read_beatmap(f)
            chart = pad_to_multiple(chart.T.astype(np.float32), bucket)[None]
            z, s = jm.apply(tree, chart, method=JLatent.encode_chart)
            with np.load(map_file.with_name(map_file.name.replace(".map.npy", ".latent.npz"))) as got:
                np.testing.assert_allclose(got["z"], np.asarray(z)[0, :n_latent], atol=1e-4)
                np.testing.assert_allclose(got["s"], np.asarray(s)[0], atol=1e-4)
                np.testing.assert_array_equal(got["labels"], labels)


# ------------------------------------------------ reconstruction figure ----


def _stage_of(monkeypatch, module, *args, **kwargs):
    """the Stage ``module.run`` builds, its ``fit`` stood in by a catch"""
    caught = {}
    monkeypatch.setattr(module, "fit", lambda stage, *a, **k: caught.setdefault("stage", stage))
    module.run(*args, **kwargs)
    return caught["stage"]


class _Figures:
    """a logger that keeps what ``figure`` is given"""
    write = True

    def __init__(self):
        self.logged = []

    def figure(self, tag, fig, step):
        self.logged.append((tag, fig, step))


def test_reconstruction_figure_matches_jax(tmp_path, monkeypatch):
    """the latent stage's ``on_validation`` on transplanted weights, both
    packages in f32: the arrays it draws (the spectrogram, the chart x, its
    reconstruction p, x - p and the up-sampled z of the first val map)
    equal the JAX callback's (1e-4, as encode-latents), logged under
    "samples" at the step given"""
    from contextlib import contextmanager
    from types import SimpleNamespace

    import osu_dreamer_tpu.data.plot as jplot
    import osu_dreamer_tpu.models.latent.fit as jfit
    import osu_dreamer_tpu_torch.data.plot as tplot
    import osu_dreamer_tpu_torch.models.latent.fit as tfit

    drawn = {}

    def catch(name):
        @contextmanager
        def plot(audio, signals):
            drawn[name] = (np.asarray(audio), [np.asarray(s) for s in signals])
            yield name

        return plot

    monkeypatch.setattr(jplot, "plot_signals", catch("jax"))
    monkeypatch.setattr(tplot, "plot_signals", catch("port"))
    cfg = _fit_config(tmp_path, "fig", 1)
    path = tmp_path / "cfg.yml"
    path.write_text(json.dumps({**cfg, "parallel": {}}))
    jm, tree = _jax_tree(13)
    # the JAX stage's model is the f32 one (its fit draws no state here:
    # the transplanted tree stands in)
    monkeypatch.setattr(jfit, "init_latent_training", lambda *a: (jm, None, None))
    jstage = _stage_of(monkeypatch, jfit, str(path))
    tstage = _stage_of(monkeypatch, tfit, cfg, device="cpu")
    tstage.state.model.load_state_dict(from_flax_params(tree, tstage.state.model))
    jlog, tlog = _Figures(), _Figures()
    jstage.on_validation(SimpleNamespace(params=tree), 3, jlog)
    tstage.on_validation(tstage.state, 3, tlog)
    assert jlog.logged == [("samples", "jax", 3)] and tlog.logged == [("samples", "port", 3)]
    (ja, js), (ta, ts) = drawn["jax"], drawn["port"]
    np.testing.assert_array_equal(ta, ja)
    assert len(ts) == len(js) == 4
    for name, t, j in zip(("x", "p", "x - p", "z"), ts, js):
        assert t.shape == j.shape and t.shape[1] == ta.shape[1], name
        np.testing.assert_allclose(t, j, atol=1e-4, err_msg=name)


def test_fit_latent_logs_the_reconstruction_figure(tmp_path, monkeypatch, capsys):
    """``fit.run`` calls the stage's ``on_validation`` after validation: a
    matplotlib figure reaches ``MetricsLogger.figure`` at the final step;
    where matplotlib cannot be imported the stage trains all the same and
    says, in one line, that it drew no figure"""
    import sys

    pytest.importorskip("matplotlib")
    from matplotlib.figure import Figure

    from osu_dreamer_tpu_torch.models.latent.fit import run
    from osu_dreamer_tpu_torch.train.logging import MetricsLogger

    logged = []
    monkeypatch.setattr(MetricsLogger, "figure",
                        lambda self, tag, fig, step: logged.append((tag, type(fig), step)))
    run(_fit_config(tmp_path, "a", 2), device="cpu")
    assert logged == [("samples", Figure, 2)]
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    state = run(_fit_config(tmp_path, "b", 2), device="cpu")
    assert state.step == 2 and logged == [("samples", Figure, 2)]
    lines = [line for line in capsys.readouterr().out.splitlines() if "figure" in line]
    assert lines == ["[latent] step 2: no reconstruction figure (matplotlib cannot be imported)"]
