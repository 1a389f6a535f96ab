"""The weight bridge: a tiny ``.odt`` written by the JAX package
(``build_artifact_bytes``, once f32 and once bf16 through ``_to_half``) read
by the port's ``load_inference``, every leaf accounted for, and the port's
LDM on injected noise equal to the JAX LDM on the same artifact (f32 compute
on both sides; 1e-3 after the samplers' steps, see test_torch_slice.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import KEY, N, T, fill_tree, tiny_args

torch.set_num_threads(1)

LABELS = np.array([[5, 9, 8, 4, 6], [2, 3, -1, 4, 5]], np.float32)


def full_tree(seed: int):
    """a complete LDM tree as training exports it: the latent model's
    chart-encoder subtrees (unused by inference) included"""
    from osu_dreamer_tpu.models.inference.model import LDM
    from osu_dreamer_tpu.models.latent.model import LatentModel

    args = tiny_args("jax")
    spec = jnp.zeros((1, 18, 72))
    tree = LDM(args, jnp.float32).init(KEY, spec, LABELS, KEY, 1, 1)
    latent = LatentModel(args.latent, jnp.float32).init(
        KEY, spec, jnp.zeros((1, 18, 9)), method=LatentModel.init_all
    )
    tree = {"params": {**tree["params"], "latent": latent["params"]}}
    return args, fill_tree(tree, seed)


@pytest.mark.parametrize("half", [False, True])
def test_odt_roundtrip_matches_jax(tmp_path, half):
    from osu_dreamer_tpu.models.inference.artifact import (
        _to_half,
        build_artifact_bytes,
    )
    from osu_dreamer_tpu.models.inference.artifact import load_inference as jload
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference as tload

    args, tree = full_tree(31)
    assert "chart_encoder" in tree["params"]["latent"]
    if half:
        tree = _to_half(tree)
    path = tmp_path / "tiny.odt"
    path.write_bytes(build_artifact_bytes(args, tree))

    jm, jparams = jload(path)
    tm = tload(path, "cpu")
    assert tm.dtype == torch.float32
    # every inference leaf carried over exactly (bf16 leaves widen exactly to f32)
    flat = {".".join(k.key for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams["params"])[0]}
    for name, value in tm.state_dict().items():
        want = flat[name]
        if name.endswith("c1.kernel") or name.endswith("c2.kernel"):
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(N(value), want, err_msg=name)

    spec = np.random.default_rng(0).random((1, 36, 72)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rng_style, rng_z = jax.random.split(key)
    s0 = np.asarray(jax.random.normal(rng_style, (2, args.style.style_dim), jnp.float32))
    x0 = np.asarray(jax.random.normal(rng_z, (2, 4, args.diffusion.emb_dim), jnp.float32))
    chart_j, lab_j = jax.jit(lambda p: jm.apply(p, spec, LABELS, key, 2, 3))(jparams)
    with torch.inference_mode():
        chart_t, lab_t = tm(T(spec), T(LABELS), 2, 3, s0=T(s0), x0=T(x0))
    np.testing.assert_allclose(N(chart_t), np.asarray(chart_j), atol=1e-3)
    np.testing.assert_allclose(N(lab_t), np.asarray(lab_j), atol=1e-3)


def _tiny_odt(tmp_path):
    from osu_dreamer_tpu.models.inference.artifact import build_artifact_bytes

    args, tree = full_tree(33)
    path = tmp_path / "tiny.odt"
    path.write_bytes(build_artifact_bytes(args, tree))
    return path


def test_load_inference_defaults_to_the_card(tmp_path):
    """with no device asked for, ``load_inference`` loads onto the card, as
    the port's other entry points run there; without one it raises (as
    ``fit.run`` does) rather than load on the CPU unasked"""
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference

    path = _tiny_odt(tmp_path)
    if torch.cuda.is_available():
        model = load_inference(path)
        assert next(model.parameters()).is_cuda and model.dtype == torch.bfloat16
        return
    with pytest.raises(RuntimeError, match="no CUDA device: pass device='cpu'"):
        load_inference(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_inference(path, "cuda")


def test_load_inference_on_the_cpu_when_asked(tmp_path):
    """``device="cpu"`` still loads: f32 parameters and compute on the CPU"""
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference

    model = load_inference(_tiny_odt(tmp_path), "cpu")
    assert model.dtype == torch.float32
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in model.parameters())


def test_bridge_accounts_for_every_leaf():
    """an unknown leaf, a missing parameter or a wrong shape raises; every
    leaf of the tree, the latent model's chart encoder included, maps onto
    the port"""
    from osu_dreamer_tpu_torch.models.inference.artifact import _flatten, from_flax_params
    from osu_dreamer_tpu_torch.models.inference.model import LDM

    _, tree = full_tree(32)
    model = LDM(tiny_args("torch"), torch.float32)
    state = from_flax_params(tree, model)
    leaves = set(_flatten(tree["params"]))
    assert any(k.startswith("latent.chart_encoder.") for k in leaves)
    assert leaves == set(state) == set(model.state_dict())

    # bf16 numpy leaves (a half tree as flax reads it) carry over bit for bit
    from osu_dreamer_tpu.models.inference.artifact import _to_half

    half = from_flax_params(_to_half(tree), model)
    for name, t in half.items():
        assert t.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(N(t), N(state[name].to(torch.bfloat16)), err_msg=name)

    extra ={"params": {**tree["params"], "diffusion": {**tree["params"]["diffusion"],
                                                        "stray": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="stray"):
        from_flax_params(extra, model)

    style = dict(tree["params"]["style"])
    del style["out_gamma"]
    with pytest.raises(KeyError, match="out_gamma"):
        from_flax_params({"params": {**tree["params"], "style": style}}, model)

    style = {**tree["params"]["style"], "out_gamma": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="out_gamma"):
        from_flax_params({"params": {**tree["params"], "style": style}}, model)
