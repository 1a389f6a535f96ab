"""The port's ``.odt`` writer (``export-inference``) against the JAX package
on the CPU.

A filled flax LDM tree (tests/test_torch_artifact.py's ``full_tree``) goes
into the port's three training checkpoints through ``from_flax_params``:
the latent stage's live weights, and for the denoiser and the style prior
the tree as their EMA weights beside live weights that differ from it, so
the export must take the EMA. ``save_inference`` merges them. Then:
- the JAX ``load_inference`` reads every leaf back exactly (f32; with
  ``half``, bit for bit the JAX ``_to_half`` of the tree, in bf16);
- the port's ``load_inference(device="cpu")`` gives the same state dict;
- the JAX LDM on the port-written artifact and the port's LDM agree with
  the noise injected, within tests/test_torch_artifact.py's 1e-3;
- the ``export-inference`` command writes the same, and without a card its
  default device raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_artifact import LABELS, full_tree
from test_torch_modules import TINY_DIFFUSION, TINY_LATENT, TINY_STYLE, N, T, tiny_args

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree():
    """the filled tree, made once: flax's eager init of it takes most of
    this file's time"""
    return full_tree(41)[1]


def _write_checkpoints(tmp_path, tree) -> list:
    """the tree as the port's latent, denoiser and style checkpoints ->
    their directories"""
    from osu_dreamer_tpu_torch.models.diffusion.train import DiffusionTrainArgs
    from osu_dreamer_tpu_torch.models.diffusion.train import init_diffusion_training
    from osu_dreamer_tpu_torch.models.inference.artifact import from_flax_params
    from osu_dreamer_tpu_torch.models.inference.model import LDM
    from osu_dreamer_tpu_torch.models.latent.train import LatentTrainArgs, init_latent_training
    from osu_dreamer_tpu_torch.models.style.train import StyleTrainArgs, init_style_training
    from osu_dreamer_tpu_torch.train.checkpoint import save_train_checkpoint

    args = tiny_args("torch")
    sd = from_flax_params(tree, LDM(args, torch.float32))
    stages = (("latent", init_latent_training, args.latent, LatentTrainArgs(), TINY_LATENT),
              ("diffusion", init_diffusion_training, args.diffusion, DiffusionTrainArgs(),
               TINY_DIFFUSION),
              ("style", init_style_training, args.style, StyleTrainArgs(), TINY_STYLE))
    paths = []
    for part, init, model_args, train_args, model_cfg in stages:
        state, _ = init(model_args, train_args, 0, "cpu", torch.float32)
        weights = {k[len(part) + 1:]: v for k, v in sd.items() if k.startswith(part + ".")}
        if state.ema_model is None:
            state.model.load_state_dict(weights)
        else:
            state.ema_model.load_state_dict(weights)
            state.model.load_state_dict({k: v + 1.0 for k, v in weights.items()})
        path = tmp_path / part / "best"
        save_train_checkpoint(path, state, {"model": model_cfg, "train": {}}, 0.0)
        paths.append(path)
    return paths


@pytest.mark.parametrize("half", [False, True])
def test_export_reads_back_in_both_packages(tmp_path, tree, half):
    from osu_dreamer_tpu.models.inference.artifact import _to_half
    from osu_dreamer_tpu.models.inference.artifact import load_inference as jload
    from osu_dreamer_tpu_torch.models.inference.artifact import (
        from_flax_params, load_inference, save_inference,
    )
    from osu_dreamer_tpu_torch.models.inference.model import LDM

    out = tmp_path / "inference.odt"
    save_inference(*_write_checkpoints(tmp_path, tree), out, half=half, device="cpu")

    jm, jparams = jload(out)
    assert jm.args == tiny_args("jax")
    want = _to_half(tree) if half else tree
    got_leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    want_leaves = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in got_leaves:
        ref = np.asarray(want_leaves[path])
        leaf = np.asarray(leaf)
        assert leaf.dtype == ref.dtype == (jnp.bfloat16 if half else np.float32), path
        assert leaf.shape == ref.shape, path
        np.testing.assert_array_equal(leaf.view(np.uint16 if half else np.uint32),
                                      ref.view(np.uint16 if half else np.uint32), err_msg=str(path))

    model = load_inference(out, "cpu")
    assert model.dtype == torch.float32
    ref = from_flax_params(tree, LDM(tiny_args("torch"), torch.float32))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        v = v.to(torch.bfloat16).float() if half else v
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("half", [False, True])
def test_jax_sampler_on_port_export_matches_port(tmp_path, tree, half):
    """the JAX LDM on the artifact the port wrote, and the port's LDM on it
    with the JAX draws injected (f32 compute on both sides)"""
    from osu_dreamer_tpu.models.inference.artifact import load_inference as jload
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference, save_inference

    out = tmp_path / "inference.odt"
    save_inference(*_write_checkpoints(tmp_path, tree), out, half=half, device="cpu")
    jm, jparams = jload(out)
    tm = load_inference(out, "cpu")

    spec = np.random.default_rng(1).random((1, 36, 72)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    rng_style, rng_z = jax.random.split(key)
    s0 = np.asarray(jax.random.normal(rng_style, (2, tm.args.style.style_dim), jnp.float32))
    x0 = np.asarray(jax.random.normal(rng_z, (2, 4, tm.args.diffusion.emb_dim), jnp.float32))
    chart_j, lab_j = jax.jit(lambda p: jm.apply(p, spec, LABELS, key, 2, 3))(jparams)
    with torch.inference_mode():
        chart_t, lab_t = tm(T(spec), T(LABELS), 2, 3, s0=T(s0), x0=T(x0))
    np.testing.assert_allclose(N(chart_t), np.asarray(chart_j), atol=1e-3)
    np.testing.assert_allclose(N(lab_t), np.asarray(lab_j), atol=1e-3)


def test_to_flax_params_inverts_from_flax_params(tree):
    """state dict -> flax tree -> state dict is the identity; conv kernels
    travel in flax's (kh, kw, in, out) layout"""
    from osu_dreamer_tpu_torch.models.inference.artifact import from_flax_params, to_flax_params
    from osu_dreamer_tpu_torch.models.inference.model import LDM

    model = LDM(tiny_args("torch"), torch.float32)
    model.load_state_dict(from_flax_params(tree, model))
    back = to_flax_params(model)
    flat_tree = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), back))[0])
    assert len(flat_tree) == len(flat_back)
    for path, leaf in flat_tree:
        np.testing.assert_array_equal(flat_back[path], np.asarray(leaf), err_msg=str(path))
    state = from_flax_params(back, model)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k


def test_export_inference_cli(tmp_path, tree, capsys):
    from osu_dreamer_tpu.models.inference.artifact import load_inference as jload
    from osu_dreamer_tpu_torch.cli import main

    latent, denoiser, style = _write_checkpoints(tmp_path, tree)
    out = tmp_path / "cli.odt"
    main(["export-inference", "--latent-ckpt-path", str(latent), "--denoiser-ckpt-path",
          str(denoiser), "--style-ckpt-path", str(style), "--output-path", str(out), "--half",
          "--device", "cpu"])
    assert f"wrote {out}" in capsys.readouterr().out
    _, params = jload(out)
    assert all(np.asarray(x).dtype == jnp.bfloat16 for x in jax.tree.leaves(params))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["export-inference", "--latent-ckpt-path", str(latent), "--denoiser-ckpt-path",
                  str(denoiser), "--style-ckpt-path", str(style), "--output-path", str(out)])
