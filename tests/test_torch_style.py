"""Style-prior training in the port (osu_dreamer_tpu_torch/models/style/
{model,train,fit}.py) against the JAX package on the CPU.

The whole-step test transplants a flax parameter tree whose EVERY leaf is
refilled from a numpy seed (``fill_tree``), draws t, s0 and the label-drop
mask the way the JAX loss draws them and injects them into the port, and
compares one f32 step: the loss terms, every gradient leaf, the parameters
after clip + AdamW and the EMA. The tolerances are
tests/test_torch_train.py's, for the same reason (f32 on both sides, only
the products' summation order differs).

The validation metrics are held to the JAX math on one given sample stack:
the JAX metric program runs with a stand-in model whose sampler returns the
stack (jitted, as the package runs it: eagerly its ``d + inf * eye(B)``
would be NaN off the diagonal). The metrics agree within 1e-5 relative, the
energy distance (a difference of mean distances that nearly cancel) within
1e-5 of the mean sample-to-real distance.
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

from osu_dreamer_tpu_torch.data.synth import write_latent_corpus
from osu_dreamer_tpu_torch.models.inference.artifact import _flatten, from_flax_params
from test_torch_modules import KEY, N, T, fill_tree

torch.set_num_threads(1)
F32 = jnp.float32

TINY_MODEL = dict(style_dim=8, label_features=16, h_dim=32, depth=2, expand=2)


def _args(package: str, **opt):
    if package == "jax":
        from osu_dreamer_tpu.models.style.model import StyleModelArgs
        from osu_dreamer_tpu.models.style.train import StyleTrainArgs
        from osu_dreamer_tpu.utils import dataclass_from_dict
    else:
        from osu_dreamer_tpu_torch.models.style.model import StyleModelArgs
        from osu_dreamer_tpu_torch.models.style.train import StyleTrainArgs
        from osu_dreamer_tpu_torch.utils import dataclass_from_dict
    train = {"opt": {"schedule": {"warmup_init": 0.3, "warmup_steps": 10, "decay_start": 20},
                     **opt}}
    return (dataclass_from_dict(StyleModelArgs, TINY_MODEL),
            dataclass_from_dict(StyleTrainArgs, train))


def _batch(seed: int, B: int = 6):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, 8)).astype(np.float32)
    labels = rng.uniform(0, 10, (B, 5)).astype(np.float32)
    return s / np.sqrt((s * s).mean(-1, keepdims=True)), labels


def test_config_copy_and_args_match_jax():
    from osu_dreamer_tpu.models.style import fit as jfit
    from osu_dreamer_tpu.models.style import model as jmodel
    from osu_dreamer_tpu.models.style import train as jtrain
    from osu_dreamer_tpu_torch.models.style import fit as tfit
    from osu_dreamer_tpu_torch.models.style import model as tmodel
    from osu_dreamer_tpu_torch.models.style import train as ttrain

    assert tfit.CONFIG.read_bytes() == (Path(jfit.__file__).parent / "config.yml").read_bytes()
    for t, j in ((ttrain.StyleTrainArgs, jtrain.StyleTrainArgs),
                 (tfit.StyleDataArgs, jfit.StyleDataArgs),
                 (tmodel.StyleModelArgs, jmodel.StyleModelArgs)):
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), t.__name__
    assert tmodel._U_BIAS_INIT == jmodel._U_BIAS_INIT


def test_init_params_matches_flax_init():
    """flax ``StyleModel.init`` and the port's ``init_params``, leaf by leaf:
    the same leaves exactly zero or constant; xavier-uniform
    ``label_proj_w`` inside its limit with the uniform's std; ``null_labels``
    at std 1/sqrt(h_dim); lecun_normal kernels at 1/sqrt(fan_in) inside
    their truncation (stds within 4 standard errors of a sample std)"""
    from osu_dreamer_tpu.models.style.model import StyleModel as JStyle
    from osu_dreamer_tpu_torch.models.style.model import StyleModel as TStyle

    ja, _ = _args("jax")
    ta, _ = _args("torch")
    jtree = jax.jit(JStyle(ja, F32).init)(KEY, np.zeros((2, 8)), np.zeros((2, 5)))
    flax_leaves = {k: np.asarray(v) for k, v in _flatten(jtree["params"]).items()}
    model = TStyle(ta, torch.float32).init_params(torch.Generator().manual_seed(0))
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
        if key == "label_proj_w":
            limit = np.sqrt(6.0 / (5 * 16 + 5 * 32))
            std, bound = limit / np.sqrt(3.0), limit
        elif key == "null_labels":
            std, bound = 32**-0.5, None
        else:
            std = int(np.prod(want.shape[:-1])) ** -0.5
            bound = 2 * std / 0.87962566103423978
        for leaf in (got, want):
            assert abs(leaf.std() - std) <= 4 * std / np.sqrt(2 * leaf.size), key
            if bound is not None:
                assert np.abs(leaf).max() <= bound * (1 + 1e-6), key
    # label_proj_w, null_labels, proj_in, 2 kernels per block
    assert n_random == 3 + 2 * TINY_MODEL["depth"]


def _jax_draws(step_rng, B: int, p: float):
    """the draws the JAX ``style_loss`` makes from ``step_rng``"""
    from osu_dreamer_tpu.train.state import stratified_logit_normal_t

    k_t, k_noise, k_drop = jax.random.split(step_rng, 3)
    return (T(stratified_logit_normal_t(k_t, B)), T(jax.random.normal(k_noise, (B, 8))),
            torch.from_numpy(np.array(jax.random.uniform(k_drop, (B, 5)) < p)))


@pytest.mark.parametrize("grad_clip", [1.0, 1e6])
def test_train_step_matches_jax(grad_clip):
    """one f32 step on transplanted params: loss terms (1e-5 relative),
    every gradient leaf (2e-5 of the largest), the params after clip +
    AdamW (the clip engaging at 1.0, not at 1e6) and the EMA (5e-6
    absolute, as tests/test_torch_train.py)"""
    import optax

    from osu_dreamer_tpu.models.style.model import StyleModel as JStyle
    from osu_dreamer_tpu.models.style.train import style_loss as jloss
    from osu_dreamer_tpu.train.state import create_train_state, ema_update, make_optimizer
    from osu_dreamer_tpu_torch.models.style.train import init_style_training, style_loss

    ja, jt = _args("jax", grad_clip=grad_clip)
    ta, tt = _args("torch", grad_clip=grad_clip)
    s, labels = _batch(0)
    jm = JStyle(ja, F32)
    tree = fill_tree(jax.jit(jm.init)(KEY, s, labels), 31)
    step_rng = jax.random.PRNGKey(7)
    tx = make_optimizer(jt.opt)

    @jax.jit
    def jax_step(tree):
        (_, aux), grads = jax.value_and_grad(
            lambda p: jloss(jm, p, step_rng, s, labels, jt), has_aux=True)(tree)
        jstate = create_train_state(tree, tx, KEY, with_ema=True)
        updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
        params = optax.apply_updates(jstate.params, updates)
        return aux, grads, params, ema_update(jstate.ema_params, params, jt.ema_decay)

    aux_j, grads_j, params_j, ema_j = jax_step(tree)
    t, s0, drop = _jax_draws(step_rng, s.shape[0], jt.label_drop_prob)
    assert 0 < int(drop.sum()) < drop.numel()  # the dropout path is exercised

    state, train_step = init_style_training(ta, tt, 0, "cpu", torch.float32)
    sd = from_flax_params(tree, state.model)
    state.model.load_state_dict(sd)
    state.ema_model.load_state_dict(sd)
    _, aux_t = style_loss(state.model, T(s), T(labels), tt, t=t, s0=s0, drop=drop)
    names = [k for k, _ in state.model.named_parameters()]
    grads_t = dict(zip(names, torch.autograd.grad(aux_t["loss"],
                                                  list(state.model.parameters()))))
    for name in ("loss", "osl", "del", "u_mape"):
        np.testing.assert_allclose(N(aux_t[name]), np.asarray(aux_j[name]), rtol=1e-5,
                                   err_msg=name)
    gmax = max(np.abs(np.asarray(g)).max() for g in jax.tree.leaves(grads_j))
    gnorm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                        for g in jax.tree.leaves(grads_j)))
    assert (gnorm > grad_clip) == (grad_clip == 1.0), gnorm
    for key, want in _flatten(grads_j["params"]).items():
        np.testing.assert_allclose(N(grads_t[key]), np.asarray(want), atol=2e-5 * gmax,
                                   err_msg=key)

    metrics = train_step(state, (T(s), T(labels)), t, s0, drop)
    assert state.step == 1 and state.opt.count == 1
    np.testing.assert_allclose(N(metrics["loss"]), np.asarray(aux_j["loss"]), rtol=1e-5)
    for got_model, want_tree in ((state.model, params_j), (state.ema_model, ema_j)):
        got = got_model.state_dict()
        for key, want in _flatten(want_tree["params"]).items():
            np.testing.assert_allclose(N(got[key]), np.asarray(want), atol=5e-6, err_msg=key)


def test_val_loss_matches_jax_without_dropout():
    """``train=False`` (validation) drops no label in either package"""
    from osu_dreamer_tpu.models.style.model import StyleModel as JStyle
    from osu_dreamer_tpu.models.style.train import style_loss as jloss
    from osu_dreamer_tpu_torch.models.style.model import StyleModel as TStyle
    from osu_dreamer_tpu_torch.models.style.train import style_loss

    ja, jt = _args("jax")
    ta, tt = _args("torch")
    s, labels = _batch(1)
    jm = JStyle(ja, F32)
    tree = fill_tree(jm.init(KEY, s, labels), 32)
    rng = jax.random.PRNGKey(3)
    _, aux_j = jloss(jm, tree, rng, s, labels, jt, train=False)
    t, s0, _ = _jax_draws(rng, s.shape[0], jt.label_drop_prob)
    model = TStyle(ta, torch.float32)
    model.load_state_dict(from_flax_params(tree, model))
    everything = torch.ones(s.shape[0], 5, dtype=torch.bool)  # ignored when not training
    _, aux_t = style_loss(model, T(s), T(labels), tt, train=False, t=t, s0=s0, drop=everything)
    for name in ("loss", "osl", "del", "u_mape"):
        np.testing.assert_allclose(N(aux_t[name]), np.asarray(aux_j[name]), rtol=1e-5,
                                   err_msg=name)


class _StackModel:
    """stands in for the flax StyleModel in the JAX metric program: its
    sampler hands out the given stack's samples in order"""

    def __init__(self, stack: np.ndarray):
        self.stack, self.calls = stack, 0

    def apply(self, params, labels, rng, steps, method=None):
        sample = jnp.asarray(self.stack[self.calls % len(self.stack)])
        self.calls += 1
        return sample


@pytest.mark.parametrize("K,B", [(4, 6), (2, 3)])
def test_sample_metrics_match_jax(K, B):
    from osu_dreamer_tpu.models.style.train import _metric_fns
    from osu_dreamer_tpu.models.style.train import energy_distance as jenergy
    from osu_dreamer_tpu_torch.models.style.train import energy_distance, nn_ratio, sample_metrics

    rng = np.random.default_rng(K * 10 + B)
    samp = rng.standard_normal((K, B, 8)).astype(np.float32)
    s_real = rng.standard_normal((B, 8)).astype(np.float32)
    labels = rng.uniform(0, 10, (B, 5)).astype(np.float32)
    metrics_fn, nn_ratio_fn = _metric_fns(_StackModel(samp))
    want = {k: float(v) for k, v in metrics_fn(None, s_real, labels, KEY, K, 16).items()}
    got = {k: float(v) for k, v in sample_metrics(T(samp), T(s_real)).items()}
    assert got.keys() == want.keys()
    scale = float(np.linalg.norm(samp.reshape(-1, 1, 8) - s_real[None], axis=-1).mean())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * scale if k == "energy_dist" else 0, err_msg=k)
    assert all(np.isfinite(v) for v in got.values()), got
    np.testing.assert_allclose(float(nn_ratio(T(samp), T(s_real))),
                               float(nn_ratio_fn(None, s_real, labels, KEY, K, 16)), rtol=1e-5)
    x, y = rng.standard_normal((7, 8)), rng.standard_normal((5, 8))
    np.testing.assert_allclose(float(energy_distance(T(x), T(y))),
                               float(jenergy(jnp.asarray(x, F32), jnp.asarray(y, F32))),
                               atol=1e-5 * float(np.linalg.norm(x[:, None] - y[None], axis=-1)
                                                 .mean()))


def test_evaluate_style_keys():
    from osu_dreamer_tpu_torch.models.style.model import StyleModel
    from osu_dreamer_tpu_torch.models.style.train import evaluate_style

    ta, _ = _args("torch")
    model = StyleModel(ta, torch.float32).init_params(torch.Generator().manual_seed(1))
    s, labels = _batch(2)
    labels[:3, 0] = 7.0
    gen = torch.Generator().manual_seed(0)
    out = evaluate_style(model, T(s), T(labels), gen, num_samples=2, sample_steps=3)
    assert sorted(out) == ["cond_recall", "energy_dist", "nn_ratio", "nn_ratio_sr5",
                           "sample_spread"]
    assert all(np.isfinite(v) for v in out.values()), out
    assert evaluate_style(model, T(s[:1]), T(labels[:1]), gen) == {}


def _fit_config(tmp: Path, run_dir: str, max_steps: int) -> dict:
    data = tmp / "data"
    if not data.exists():
        write_latent_corpus(data, 6, 3, 20, 16, 4, 8, seed=1)
    return {
        "data": {"data_dir": str(data), "batch_size": 4, "shuffle_buffer": 8,
                 "max_val_count": 2, "max_val_frac": 0.4},
        "fit": {"run_dir": str(tmp / run_dir), "max_steps": max_steps, "log_every": 100,
                "save_last_every_s": 0.0, "monitor": "val/energy_dist"},
        "train": {"opt": {"schedule": {"warmup_init": 0.3, "warmup_steps": 10}}},
        "model": TINY_MODEL,
        "parallel": {"dp": -1, "tp": 1},
    }


def test_resume_is_exact(tmp_path):
    """5 straight steps equal 2 steps, a checkpoint, a resume and 3 more, bit
    for bit (the epoch of 3 batches ends between): params, optimizer
    moments, EMA, generator, step"""
    from osu_dreamer_tpu_torch.models.style.fit import run

    straight = run(_fit_config(tmp_path, "a", 5), device="cpu")
    run(_fit_config(tmp_path, "b", 2), device="cpu")
    assert (tmp_path / "b" / "best" / "state.pt").exists()
    resumed = run(_fit_config(tmp_path, "b", 5), str(tmp_path / "b" / "last"), device="cpu")
    assert straight.step == resumed.step == 5
    a, b = straight.state_dict(), resumed.state_dict()
    for part in ("params", "ema_params"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), (part, key)
    for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]):
        assert torch.equal(x, y)
    assert torch.equal(a["generator"], b["generator"])


def test_batched_pairs_drops_the_last_partial_batch():
    from osu_dreamer_tpu.models.style.fit import _batched_pairs as jpairs
    from osu_dreamer_tpu_torch.models.style.fit import _batched_pairs

    pairs = [(np.full(2, i, np.float32), np.full(5, i, np.float32)) for i in range(7)]
    got, want = list(_batched_pairs(iter(pairs), 3)), list(jpairs(iter(pairs), 3))
    assert len(got) == len(want) == 2
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_fit_style_cli_and_refusals(tmp_path, capsys):
    """the CLI trains on the CPU when asked and writes both checkpoints with
    val/energy_dist monitored; a CUDA run without a card and parallel blocks
    the one CPU device cannot hold (tensor parallelism among them) raise
    instead of running something else"""
    from osu_dreamer_tpu_torch.cli import main
    from osu_dreamer_tpu_torch.models.style.fit import run

    cfg = _fit_config(tmp_path, "cli", 2)
    path = tmp_path / "cfg.yml"
    path.write_text(json.dumps(cfg))
    main(["fit-style", "-c", str(path), "--device", "cpu"])
    assert "val/energy_dist=" in capsys.readouterr().out
    for ckpt in ("last", "best"):
        meta = json.loads((tmp_path / "cli" / ckpt / "meta.json").read_text())
        assert meta["step"] == 2 and meta["hparams"]["model"] == cfg["model"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg)
    # the JAX refusals over one CPU device;
    # num_processes without a coordinator is ignored, as jax.distributed
    # ignores it there: one process on one device
    bad = [({"dp": 2}, ValueError, r"parallel.dp=2 but only 1 devices"),
           ({"tp": 2}, ValueError, r"1 devices not divisible by n_model=2"),
           ({"coordinator": "127.0.0.1:1", "num_processes": 2, "process_id": 0, "dp": 1},
            ValueError, "divergent")]
    for value, error, match in bad:
        with pytest.raises(error, match=match):
            run({**cfg, "parallel": value}, device="cpu")
    from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism

    par = build_parallelism(ParallelArgs(num_processes=2), cfg["data"]["batch_size"])
    assert (par.world_size, par.process_count, par.input_shard) == (1, 1, None)
    with pytest.raises(ValueError, match="parallel.sp"):
        run({**cfg, "parallel": {"sp": 2}}, device="cpu")
