"""Tensor parallelism in the port (parallel/tp.py; the TP forms of
ops/swiglu.py and ops/film_layer.py) on the CPU, in f32:
- the TP forms' plain versions, summed over uneven slices, equal the
  one-rank plain functions (hypothesis over H and tp);
- one step of the denoiser and of the latent stage on two gloo ranks equals
  the port's one-process step and the JAX package's unsharded step on the
  same weights and draws (the clip engaging and not), also dp 2 x tp 2 on
  four ranks; and at the widths whose one-rank SwiGLU backward is K5
  (384) or the plain version (144), which the card routes to K5's TP form
  and the plain TP forms, equals the one-process step;
- (tests/test_torch_parallel_tp_fit.py: two coordinator processes, the
  fits' checkpoints, resume and export, ``fit-style``).

Rank bodies are module-level functions that import no jax (a spawned rank
imports this module); the JAX references run in the test's own process.
Every spawn is bounded (tests/test_torch_parallel.py ``spawn``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism
from osu_dreamer_tpu_torch.parallel.tp import Split, even_split, layout_of
from test_torch_parallel import (
    COLLECTIVE_S, TINY_DIFFUSION, TINY_LATENT, randomize_, spawn,
)

torch.set_num_threads(1)
F32 = torch.float32
B_DENOISER, L_DENOISER = 4, 24
B_LATENT, L_LATENT = 2, 36


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------- the TP forms ----


def _ffn_weights(rng, C: int, H: int, K: int):
    def n(*shape, scale):
        return _t(rng.standard_normal(shape).astype(np.float32) * scale)

    return (n(K, C, scale=0.3), n(C, scale=0.1), n(C, 2 * H, scale=C ** -0.5),
            n(2 * H, scale=0.1), n(H, C, scale=H ** -0.5), n(C, scale=0.1))


def _slices(H: int, tp: int):
    """per rank the splits of (vg_kernel, vg_bias, out_kernel)"""
    out = []
    for r in range(tp):
        lo, hi = even_split(H, tp, r)
        out.append((Split(1, 2, 1, H, lo, hi), Split(0, 2, 1, H, lo, hi),
                    Split(0, 1, 1, H, lo, hi)))
    return out


def _close(got, want, what: str, rtol: float = 1e-5, atol: float = 0.0) -> None:
    """f32 within ``rtol`` of the largest magnitude (sums differ only in
    their order), plus ``atol``"""
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-12) if want.numel() else 1.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rtol * scale + atol, \
        f"{what}: max |err| {err:.3g} vs {rtol:g} x {scale:.3g} + {atol:.3g}"


@settings(max_examples=12, deadline=None, database=None)
@given(H=st.integers(3, 40), tp=st.sampled_from([2, 3]), film=st.booleans(),
       seed=st.integers(0, 2**16))
def test_tp_forms_sum_to_the_one_rank_function(H, tp, film, seed):
    """the K4/K6 (``film`` False) or K2/K3 TP forms' plain versions on every
    rank's slice of H hidden units (uneven where tp does not divide H): the
    workspaces summed and finished equal the one-rank forward, the dY
    partials summed and finished and the slices' weight gradients put
    together equal the one-rank backward (f32, 1e-5 of the largest)"""
    from osu_dreamer_tpu_torch.ops import film_layer as fl
    from osu_dreamer_tpu_torch.ops import swiglu as sw

    hypothesis_rng = np.random.default_rng(seed)
    B, L, C, K = 2, 7, 16, 5
    x = _t(hypothesis_rng.standard_normal((B, L, C)).astype(np.float32))
    go = _t(hypothesis_rng.standard_normal((B, L, C)).astype(np.float32))
    w = _ffn_weights(hypothesis_rng, C, H, K)
    film_args = tuple(_t(hypothesis_rng.standard_normal(s).astype(np.float32) * 0.3)
                      for s in ((B, C), (B, C), (B, C))) + (
        _t(1 + 0.1 * hypothesis_rng.standard_normal(C).astype(np.float32)),
        _t(1 + 0.1 * hypothesis_rng.standard_normal(C).astype(np.float32)))
    scale, shift, gate, g1, g2 = film_args
    splits = _slices(H, tp)
    part = [tuple(s.take(t) for s, t in zip(sp, (w[2], w[3], w[4]))) for sp in splits]
    if film:
        want = fl.film_layer_plain(x, *film_args, *w)
        ref = fl.film_layer_bwd_plain(x, *film_args, *w, go)
        buf = sum(fl.film_layer_tp_partial(x, scale, shift, gate, g1, g2, w[0], w[1], *p, H, tp)[0]
                  for p in part)
        got = fl.film_layer_tp_finish(buf, x, gate, g2, w[5], H)
        outs = [fl.film_layer_tp_bwd(x, scale, shift, gate, g1, g2, w[0], w[1], *p, w[5], go, buf,
                                     None, H, tp) for p in part]
    else:
        want = sw.swiglu_plain(x, *w)
        ref = sw.swiglu_bwd_plain(x, *w[:5], go)
        buf = sum(sw.swiglu_tp_partial(x, w[0], w[1], *p, H, tp) for p in part)
        got = sw.swiglu_tp_finish(buf, x, w[5], H)
        outs = [sw.swiglu_tp_bwd(x, w[0], w[1], *p, go, buf, H, tp) for p in part]
    _close(got, want, "forward")
    dy = sum(o[0] for o in outs)
    for o in outs:
        o[0].copy_(dy)  # the all-reduce
    full = [torch.zeros_like(t) for t in (w[2], w[3], w[4])]
    for sp, o in zip(splits, outs):
        for s, g, f in zip(sp, o[1], full):
            s.put(f, g)
    finished = [o[-1]() for o in outs]
    for f in finished[1:]:  # every rank finishes the same sum
        for a, b in zip(f, finished[0]):
            assert torch.equal(a, b)
    if film:
        dx, dscale, dshift, dg1, ddw, ddwb = finished[0]
        dgate, dg2, dbout = outs[0][2]
        got_grads = (dx, dscale, dshift, dgate, dg1, dg2, ddw, ddwb, *full, dbout)
    else:
        dx, ddw, ddwb, dbout = finished[0]
        got_grads = (dx, ddw, ddwb, *full, dbout)
    for i, (g, r) in enumerate(zip(got_grads, ref)):
        _close(g, r, f"gradient {i}")


def test_shard_model_splits_only_ruled_modules():
    """a SwiGLU whose path no rule matches keeps its whole weights and no
    ``tp`` share (so it never runs a TP form); one the rules match holds its
    slice, 11/10 of 21 hidden units"""
    from torch import nn

    from osu_dreamer_tpu_torch.nn.blocks import SwiGLU
    from osu_dreamer_tpu_torch.parallel.tp import shard_model

    for rank, width in ((0, 11), (1, 10)):
        net = nn.Module()
        net.ffn, net.proj = SwiGLU(16, 2, 1, F32), SwiGLU(16, 2, 1, F32)
        layout = shard_model(net, None, rank, 2)
        assert sorted(layout.splits) == ["ffn.out_kernel", "ffn.vg_bias", "ffn.vg_kernel"]
        assert net.ffn.out_kernel.shape == (width, 16) and net.ffn.tp.hi - net.ffn.tp.lo == width
        assert net.proj.out_kernel.shape == (21, 16) and net.proj.tp is None
        assert layout.kinds() == (["replicated", "replicated"] + ["sharded"] * 3
                                  + ["replicated"] * 7)


# ----------------------------------------------------------- one step ----


def _init(stage: str, par, seed: int, grad_clip: float, width: int | None = None,
          model: dict | None = None):
    """the stage's train state under ``par`` holding the one-process
    weights drawn from ``seed`` (``randomize_``): the whole model is drawn,
    then loaded, which slices it on a tensor-parallel rank; ``width``: the
    denoiser's backbone width in place of the tiny config's; ``model``: the
    denoiser's model config in place of the tiny one"""
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    if stage == "denoiser":
        from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModelArgs as MArgs
        from osu_dreamer_tpu_torch.models.diffusion.train import DiffusionTrainArgs as TArgs
        from osu_dreamer_tpu_torch.models.diffusion.train import init_diffusion_training as init
        model, opt = model or TINY_DIFFUSION, {"schedule": {"warmup_init": 0.3,
                                                            "warmup_steps": 10}}
        if width is not None:
            model = {**model, "backbone_dim": width}
    else:
        from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs as MArgs
        from osu_dreamer_tpu_torch.models.latent.train import LatentTrainArgs as TArgs
        from osu_dreamer_tpu_torch.models.latent.train import init_latent_training as init
        model, opt = TINY_LATENT, {"lr": 1e-3, "schedule": {"warmup_init": 0.1,
                                                            "warmup_steps": 10}}
    margs = dataclass_from_dict(MArgs, model)
    targs = dataclass_from_dict(TArgs, {"opt": {**opt, "grad_clip": grad_clip}})
    whole, _ = init(margs, targs, 0, "cpu", F32)
    randomize_(whole.model, seed)
    if whole.ema_model is not None:
        whole.ema_model.load_state_dict(whole.model.state_dict())
    if par is None:
        return whole, init(margs, targs, 0, "cpu", F32)[1], targs
    state, step = init(margs, targs, 0, "cpu", F32, par)
    state.load_state_dict(whole.state_dict())
    return state, step, targs


def _batch(stage: str, seed: int, B: int):
    rng = np.random.default_rng(seed)
    if stage == "denoiser":
        L = L_DENOISER
        return (rng.random((B, L, 16), dtype=np.float32),
                rng.standard_normal((B, L, 6)).astype(np.float32),
                rng.standard_normal((B, 8)).astype(np.float32),
                rng.uniform(0, 10, (B, 5)).astype(np.float32))
    L = L_LATENT
    return (rng.random((B, L, 72), dtype=np.float32), rng.random((B, L, 9), dtype=np.float32),
            rng.uniform(0, 10, (B, 5)).astype(np.float32))


def _step(stage: str, par, seed: int, grad_clip: float, batch_np, draws_np,
          host_rows: slice | None = None, width: int | None = None,
          model: dict | None = None) -> dict:
    """one step of ``stage`` under ``par`` (None: one process) on the global
    batch ``batch_np`` (``host_rows``: the rows this host loads) with the
    injected global draws -> its metrics, whole gradients and whole state"""
    from osu_dreamer_tpu_torch.models.diffusion.train import LatentBatch
    from osu_dreamer_tpu_torch.models.latent.train import Batch, LatentDraws

    state, train_step, targs = _init(stage, par, seed, grad_clip, width, model)
    norms = []  # the norm the optimizer clips by, as AdamW.step returns it
    opt_step = state.opt.step
    state.opt.step = lambda grads, norm=None: norms.append(opt_step(grads, norm)) or norms[-1]
    host = tuple(_t(x[host_rows] if host_rows is not None else x) for x in batch_np)
    local = par.shard_batch(host) if par is not None else host
    layout = layout_of(state.model)
    if stage == "denoiser":
        from osu_dreamer_tpu_torch.models.diffusion.train import step_gradients

        t, x0 = map(_t, draws_np)
        metrics, grads = step_gradients(state.model, LatentBatch(*local), targs, None, t, x0, par)
        metrics = train_step(state, LatentBatch(*local), t, x0)
    else:
        from osu_dreamer_tpu_torch.models.latent.train import step_gradients

        draws = LatentDraws(*map(_t, draws_np))
        _, _, grads = step_gradients(state, Batch(*local), targs, draws, par)
        metrics = train_step(state, Batch(*local), draws)
    names = [n for n, _ in state.model.named_parameters()]
    if layout is not None:
        grads = [layout.gather(n, g) for n, g in zip(names, grads)]
    return {"metrics": {k: v.detach() for k, v in metrics.items()},
            "grads": dict(zip(names, grads)), "norm": float(norms[0]),
            "state": state.state_dict(),
            "sharded": sorted(layout.splits) if layout is not None else []}


def _step_rank(out: str, stage: str, args: dict, seed: int, grad_clip: float, batch_np,
               draws_np, width: int | None = None, model: dict | None = None) -> None:
    par = build_parallelism(ParallelArgs(**args), batch_np[0].shape[0],
                            ["cpu"] * (args.get("tp", 1) * args.get("dp", 1)),
                            timeout_s=COLLECTIVE_S)
    got = _step(stage, par, seed, grad_clip, batch_np, draws_np, width=width, model=model)
    torch.save({**got, "rank": par.rank, "model_group": par.model_rank},
               Path(out) / f"rank{par.rank}.pt")


def _jax_denoiser(whole_sd: dict, batch_np, grad_clip: float, step_key: int,
                  model: dict | None = None):
    """the JAX package's unsharded step on the same weights (``model``: the
    model config, by default the tiny one) -> (draws (t, x0) as numpy,
    metrics, the params after the step as port names)"""
    import jax
    import optax

    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu.models.diffusion.model import DiffusionModelArgs as JArgs
    from osu_dreamer_tpu.models.diffusion.train import DiffusionTrainArgs as JTrain
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu.train.state import (
        create_train_state, make_optimizer, stratified_logit_normal_t,
    )
    from osu_dreamer_tpu.utils import dataclass_from_dict

    ja = dataclass_from_dict(JArgs, model or TINY_DIFFUSION)
    jt = dataclass_from_dict(JTrain, {"opt": {"schedule": {"warmup_init": 0.3,
                                                           "warmup_steps": 10},
                                              "grad_clip": grad_clip}})
    jm, tx = JDiff(ja, jax.numpy.float32), make_optimizer(jt.opt)
    tree = _flax_tree(whole_sd)
    step_rng = jax.random.PRNGKey(step_key)
    (_, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, step_rng, JBatch(*batch_np), jt), has_aux=True))(tree)
    jstate = create_train_state(tree, tx, jax.random.PRNGKey(0), with_ema=True)
    updates, _ = tx.update(grads, jstate.opt_state, jstate.params)
    params = optax.apply_updates(jstate.params, updates)
    k_t, k_noise = jax.random.split(step_rng)
    draws = (np.asarray(stratified_logit_normal_t(k_t, batch_np[1].shape[0])),
             np.asarray(jax.random.normal(k_noise, batch_np[1].shape, jax.numpy.float32)))
    return draws, {k: np.asarray(v) for k, v in aux.items()}, _port_names(params), grads


def _jax_latent(whole_sd: dict, batch_np, grad_clip: float, step_key: int):
    """the JAX package's unsharded latent step on the same weights (the
    first step: components normalised by themselves) -> (the seven draws,
    metrics, the params after the step as port names)"""
    import jax
    import jax.numpy as jnp
    import optax

    from osu_dreamer_tpu.models.latent import train as jtrain
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent
    from osu_dreamer_tpu.models.latent.model import LatentModelArgs as JArgs
    from osu_dreamer_tpu.train.state import make_optimizer
    from osu_dreamer_tpu.utils import dataclass_from_dict
    from osu_dreamer_tpu_torch.models.latent.train import LOSS_WEIGHTS

    ja = dataclass_from_dict(JArgs, TINY_LATENT)
    jt = dataclass_from_dict(jtrain.LatentTrainArgs, {
        "opt": {"lr": 1e-3, "schedule": {"warmup_init": 0.1, "warmup_steps": 10},
                "grad_clip": grad_clip}})
    jm, tx = JLatent(ja, jnp.float32), make_optimizer(jt.opt)
    tree = _flax_tree(whole_sd)
    step_rng = jax.random.PRNGKey(step_key)
    jbatch = jtrain.Batch(*map(jnp.asarray, batch_np))

    def loss(params):
        comps, aux, s_reg = jtrain.latent_loss(jm, params, step_rng, jbatch, jt, True)
        total = (LOSS_WEIGHTS * comps / jnp.clip(jax.lax.stop_gradient(comps), 1e-8)).sum()
        total = total + jt.s_reg_weight * s_reg
        return total, {**aux, "loss": total}

    (_, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    updates, _ = tx.update(grads, tx.init(tree), tree)
    params = optax.apply_updates(tree, updates)
    n, l = 2 * batch_np[0].shape[0], L_LATENT // 2 // ja.chunk_size
    keys = jax.random.split(step_rng, 7)
    draws = (jax.random.normal(keys[0], (n, ja.style_dim)),
             jax.random.normal(keys[1], (n, ja.style_dim), jnp.float32),
             jax.random.normal(keys[2], (n, l, ja.emb_dim), jnp.float32),
             jax.random.uniform(keys[3], (n,)),
             jax.random.normal(keys[4], (n, ja.style_dim), jnp.float32),
             jax.random.uniform(keys[5], (n,)), jax.random.uniform(keys[6], (n,)))
    return (tuple(np.asarray(d) for d in draws), {k: np.asarray(v) for k, v in aux.items()},
            _port_names(params), grads)


def _flax_tree(state_dict: dict) -> dict:
    """a port model's state dict as its flax tree (models/inference/
    artifact.py ``to_flax_params``: nested by ``.``, the 2-D conv kernels in
    flax's (kh, kw, in, out))"""
    import jax.numpy as jnp

    params: dict = {}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        a = t.detach().numpy()
        node[name] = jnp.asarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)
    return {"params": params}


def _port_names(tree) -> dict[str, np.ndarray]:
    from osu_dreamer_tpu_torch.models.inference.artifact import _flatten

    return {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}


def _conv_to_port(key: str, x: np.ndarray) -> np.ndarray:
    return np.transpose(x, (3, 2, 0, 1)) if x.ndim == 4 else x


def _check_step(ranks: list[dict], ref: dict, jax_metrics: dict, jax_params: dict, lr0: float,
                metric_names, jax_grads) -> None:
    """the ranks' step against the one-process step (metrics 1e-5 relative,
    the gradient norm the clip reads 1e-5 relative and 1e-4 to the JAX one's,
    gradients 1e-5 of the largest, the params after the step within 1e-5 of
    the largest plus 5 % of the first step's rate where the gradient stands
    above the sums' rounding and within one step elsewhere: Adam's first
    step is g / (|g| + 1e-8) times the rate) and against the JAX unsharded
    step with the JAX tolerances of tests/test_parallel.py
    (``test_tensor_parallel_matches_single_device``): loss rtol 1e-5, the
    params rtol 1e-4 atol 1e-6 where the gradient is settled, one step
    elsewhere; every rank's whole state the same bit for bit"""
    for name in metric_names:
        for rank in ranks:
            _close(rank["metrics"][name], ref["metrics"][name], name)
            np.testing.assert_allclose(float(rank["metrics"][name]), float(jax_metrics[name]),
                                       rtol=1e-5, err_msg=name)
    import jax

    jax_norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                           for g in jax.tree.leaves(jax_grads)))
    for rank in ranks:
        np.testing.assert_allclose(rank["norm"], ref["norm"], rtol=1e-5, err_msg="norm")
        np.testing.assert_allclose(rank["norm"], jax_norm, rtol=1e-4, err_msg="JAX norm")
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    for name, want in ref["grads"].items():
        err = float((ranks[0]["grads"][name] - want).abs().max())
        assert err <= 1e-5 * gmax, f"gradient {name}: {err:.3g} vs 1e-5 x {gmax:.3g}"
    for rank in ranks[1:]:
        for part in ("params", "ema_params"):
            if ranks[0]["state"][part] is not None:
                for k, v in ranks[0]["state"][part].items():
                    assert torch.equal(rank["state"][part][k], v), (part, k)
    got = ranks[0]["state"]["params"]
    for name, want in ref["state"]["params"].items():
        settled = ref["grads"][name].abs() >= 1e-5 * gmax
        _close(got[name][settled], want[settled], f"params {name}", atol=0.05 * lr0)
        _close(got[name], want, f"params {name}", atol=1.05 * lr0)
        j = torch.from_numpy(_conv_to_port(name, jax_params[name]).copy())
        np.testing.assert_allclose(got[name][settled].numpy(), j[settled].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), j.numpy(), atol=1.05 * lr0, err_msg=name)


@pytest.mark.parametrize("stage, grad_clip", [("denoiser", 1.0), ("denoiser", 1e6),
                                              ("latent", 1.0)])
def test_tp_step_equals_one_process_and_jax(tmp_path, stage, grad_clip):
    """one step on two tensor-parallel ranks (the attention heads and the
    FFN hidden units split: 1 head of 2, 85 hidden units of 170; the latent
    FilmStacks' 21/21 of 42) equals the port's one-process step and the JAX
    package's unsharded step on the same weights and draws; at grad_clip 1.0
    the clip engages, so the whole model's norm decides the update"""
    seed, B = 5, (B_DENOISER if stage == "denoiser" else B_LATENT)
    batch_np = _batch(stage, seed, B)
    whole, _, _ = _init(stage, None, seed, grad_clip)
    jax_ref = (_jax_denoiser if stage == "denoiser" else _jax_latent)(
        whole.model.state_dict(), batch_np, grad_clip, 9)
    draws_np, jax_metrics, jax_params, jax_grads = jax_ref
    spawn(_step_rank, str(tmp_path), stage, {"tp": 2}, seed, grad_clip, batch_np, draws_np)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["sharded"] and [r["model_group"] for r in ranks] == [0, 1]
    ref = _step(stage, None, seed, grad_clip, batch_np, draws_np)
    assert (ref["norm"] > grad_clip) == (grad_clip == 1.0), ref["norm"]  # the clip engages
    lr0 = 3e-4 * 0.3 if stage == "denoiser" else 1e-3 * 0.1
    names = ("loss", "osl", "del") if stage == "denoiser" else ("loss", "s_reg", "hit/onset")
    _check_step(ranks, ref, jax_metrics, jax_params, lr0, names, jax_grads)


def test_dp2_tp2_step_on_four_ranks(tmp_path):
    """(data=2, model=2): each model group takes half the rows with the
    global draws; the step equals the one-process step on the whole batch
    (and the JAX unsharded step), every rank's whole state the same"""
    seed, grad_clip = 6, 1.0
    batch_np = _batch("denoiser", seed, B_DENOISER)
    whole, _, _ = _init("denoiser", None, seed, grad_clip)
    draws_np, jax_metrics, jax_params, jax_grads = _jax_denoiser(whole.model.state_dict(),
                                                                 batch_np, grad_clip, 3)
    spawn(_step_rank, str(tmp_path), "denoiser", {"tp": 2, "dp": 2}, seed, grad_clip, batch_np,
          draws_np, ranks=4)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(4)]
    assert [r["model_group"] for r in ranks] == [0, 1, 0, 1]
    ref = _step("denoiser", None, seed, grad_clip, batch_np, draws_np)
    _check_step(ranks, ref, jax_metrics, jax_params, 3e-4 * 0.3, ("loss", "osl", "del"),
                jax_grads)


@pytest.mark.parametrize("width, route", [(384, "full"), (144, "plain")])
def test_tp_step_at_every_width_one_rank_training_takes(tmp_path, width, route):
    """tensor parallelism refuses no width that one-rank training takes: a
    denoiser of backbone width 384 (the one-rank SwiGLU backward is K5, so
    a slice on the card takes K5's TP form) and of width 144 (C % 32 != 0:
    the one-rank backward is the plain version, so is the slice's) trains
    one step on two gloo ranks equal to the one-process step: the loss
    terms 1e-5 relative, the gradient norm 1e-5 relative, every gradient
    within 1e-5 of the largest, the ranks' whole states equal bit for bit
    and the params within 1e-5 of the largest plus one step's rate"""
    from osu_dreamer_tpu_torch.ops.swiglu import swiglu_tp_route

    H = int(width * TINY_DIFFUSION["backbone"]["expand"] * 2 / 3)
    assert swiglu_tp_route(width, 5, H, 2, torch.device("cuda"))[1] == route
    seed, grad_clip = 7, 1.0
    batch_np = _batch("denoiser", seed, B_DENOISER)
    rng = np.random.default_rng(seed)
    draws_np = (rng.uniform(0.05, 0.95, B_DENOISER).astype(np.float32),
                rng.standard_normal((B_DENOISER, L_DENOISER, 6)).astype(np.float32))
    spawn(_step_rank, str(tmp_path), "denoiser", {"tp": 2}, seed, grad_clip, batch_np, draws_np,
          width)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["sharded"]
    ref = _step("denoiser", None, seed, grad_clip, batch_np, draws_np, width=width)
    for name in ("loss", "osl", "del"):
        for rank in ranks:
            _close(rank["metrics"][name], ref["metrics"][name], name)
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    for rank in ranks:
        np.testing.assert_allclose(rank["norm"], ref["norm"], rtol=1e-5, err_msg="norm")
        for name, want in ref["grads"].items():
            _close(rank["grads"][name], want, f"gradient {name}", rtol=0.0, atol=1e-5 * gmax)
    for part in ("params", "ema_params"):
        for k, v in ranks[0]["state"][part].items():
            assert torch.equal(ranks[1]["state"][part][k], v), (part, k)
            _close(v, ref["state"][part][k], f"{part} {k}", atol=1.05 * 3e-4 * 0.3)
