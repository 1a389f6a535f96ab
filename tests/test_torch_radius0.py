"""SwiGLU without its depthwise conv (``radius: 0``), which the JAX package
runs (osu_dreamer_tpu/nn/blocks.py: no ``dw_kernel``/``dw_bias`` leaves, the
gated FFN straight off its input, FilmStack's unfused layer), against the
port on the CPU in f32:
- ``SwiGLU``, ``FilmStack``, ``DiffusionModel`` and ``LatentModel`` at
  radius 0 load a radius-0 flax tree leaf for leaf (``from_flax_params``)
  and match the flax modules forward and in their gradients;
- ``init_params`` draws the leaves flax's init draws, and no conv;
- the port's unit tap (a (1, C) kernel of ones and a zero bias, with which
  the kernels run radius 0 on the card) leaves the plain version equal to
  the conv-free function bit for bit in bf16, gradients included;
- one sp 2 and one tp 2 step of a radius-0 denoiser equal the JAX
  package's unsharded step (spawned gloo ranks), the sp step exchanging no
  halo in the FFNs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.models.inference.artifact import _flatten, from_flax_params
from test_torch_modules import KEY, N, T, fill_tree, port, randn
from test_torch_parallel import TINY_DIFFUSION, TINY_LATENT

torch.set_num_threads(1)
F32 = jnp.float32
DIFFUSION_R0 = {**TINY_DIFFUSION, "backbone": {**TINY_DIFFUSION["backbone"], "radius": 0}}
LATENT_R0 = {**TINY_LATENT, "stack": {**TINY_LATENT["stack"], "radius": 0}}


def _grads_match(port_model: torch.nn.Module, jax_grads, atol: float) -> None:
    """every parameter's gradient (``.grad``) equals the flax tree's leaf"""
    want = {k: np.asarray(v) for k, v in _flatten(jax_grads["params"]).items()}
    got = {k: p.grad for k, p in port_model.named_parameters()}
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        g = N(got[key])
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        np.testing.assert_allclose(g, w, atol=atol * top, err_msg=key)


def _init_rule(flax_tree, model: torch.nn.Module) -> int:
    """flax's init and the port's ``init_params`` leaf by leaf, as
    tests/test_torch_train.py holds them: the same constant leaves, the
    random ones at lecun_normal's std (4 standard errors) inside the
    truncation -> the number of random leaves"""
    from osu_dreamer_tpu_torch.models.inference.artifact import _conv_kernels

    conv = _conv_kernels(model)
    flax_leaves = {k: np.asarray(v) for k, v in _flatten(flax_tree["params"]).items()}
    port_leaves = {k: N(v.permute(2, 3, 1, 0) if k in conv else v)
                   for k, v in model.state_dict().items()}
    assert set(port_leaves) == set(flax_leaves)
    assert not any("dw_" in k for k in port_leaves)
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
    return n_random


# -------------------------------------------------------------- modules ----


def test_swiglu_radius0_matches_flax():
    """no conv leaves; the output and every gradient (input and leaves)
    equal flax's (1e-5)"""
    from osu_dreamer_tpu.nn.blocks import SwiGLU as JSwiGLU
    from osu_dreamer_tpu_torch.nn.blocks import SwiGLU as TSwiGLU

    x, cot = randn(0, 2, 29, 16), randn(1, 2, 29, 16)
    jm = JSwiGLU(16, 2, 0, dtype=F32)
    tree = fill_tree(jm.init(KEY, x), 2)
    assert sorted(tree["params"]) == ["out_bias", "out_kernel", "vg_bias", "vg_kernel"]
    tm = port(TSwiGLU(16, 2, 0, torch.float32), tree)
    assert list(tm.state_dict()) == ["vg_kernel", "vg_bias", "out_kernel", "out_bias"]
    xt = T(x).requires_grad_()
    out = tm(xt)
    np.testing.assert_allclose(N(out), np.asarray(jm.apply(tree, x)), atol=1e-5)
    (out * T(cot)).sum().backward()
    jgrad, jx = jax.grad(lambda p, x: (jm.apply(p, x) * cot).sum(), argnums=(0, 1))(tree, x)
    np.testing.assert_allclose(N(xt.grad), np.asarray(jx), atol=1e-5)
    _grads_match(tm, jgrad, 1e-5)


@pytest.mark.parametrize("cond_dim", [0, 8])
def test_filmstack_radius0_matches_flax(cond_dim):
    """the JAX stack's unfused layer at radius 0 (no FiLM or with it):
    output and gradients (input, condition, leaves) within 1e-5"""
    from osu_dreamer_tpu.nn.blocks import FilmStack as JStack
    from osu_dreamer_tpu_torch.nn.blocks import FilmStack as TStack

    x, cot = randn(0, 3, 31, 16), randn(2, 3, 31, 16)
    cond = randn(1, 3, cond_dim) if cond_dim else None
    jm = JStack(16, cond_dim, 2, expand=2, radius=0, dtype=F32)
    tree = fill_tree(jm.init(KEY, x, cond), 3)
    tm = port(TStack(16, cond_dim, 2, 2, 0, torch.float32), tree)
    xt = T(x).requires_grad_()
    ct = None if cond is None else T(cond).requires_grad_()
    out = tm(xt, ct)
    np.testing.assert_allclose(N(out), np.asarray(jm.apply(tree, x, cond)), atol=1e-5)
    (out * T(cot)).sum().backward()  # gradients within 1e-5 of their largest
    if cond is None:
        jgrad, jx = jax.grad(lambda p, x: (jm.apply(p, x, None) * cot).sum(),
                             argnums=(0, 1))(tree, x)
    else:
        jgrad, jx, jc = jax.grad(lambda p, x, c: (jm.apply(p, x, c) * cot).sum(),
                                 argnums=(0, 1, 2))(tree, x, cond)
        np.testing.assert_allclose(N(ct.grad), np.asarray(jc), atol=1e-5 * np.abs(jc).max())
    np.testing.assert_allclose(N(xt.grad), np.asarray(jx), atol=1e-5 * np.abs(jx).max())
    _grads_match(tm, jgrad, 1e-5)


def _diffusion(package: str):
    if package == "jax":
        from osu_dreamer_tpu.models.diffusion.model import DiffusionModel, DiffusionModelArgs
        from osu_dreamer_tpu.utils import dataclass_from_dict
    else:
        from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
        from osu_dreamer_tpu_torch.utils import dataclass_from_dict
    return DiffusionModel, dataclass_from_dict(DiffusionModelArgs, DIFFUSION_R0)


def test_diffusion_model_radius0_matches_jax():
    """a radius-0 denoiser from a radius-0 flax tree: predict and a 3-step
    ``sample`` on injected noise (1e-5, 1e-4), and the training loss's
    terms and every gradient (``diffusion_loss`` with the JAX draws
    injected: 1e-5 relative, 2e-5 of the largest gradient)"""
    from osu_dreamer_tpu.models.diffusion.train import DiffusionTrainArgs as JTrain
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from osu_dreamer_tpu.train.state import stratified_logit_normal_t
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, diffusion_loss,
    )

    JDiff, ja = _diffusion("jax")
    TDiff, ta = _diffusion("torch")
    audio, style, xt = randn(0, 2, 13, 16), randn(1, 2, 8), randn(2, 2, 13, 6)
    jm = JDiff(ja, F32)
    tree = fill_tree(jm.init(KEY, audio, style, xt), 8)
    assert not any("dw_" in k for k in _flatten(tree["params"]))
    tm = port(TDiff(ta, torch.float32), tree)
    u_j, v_j = jm.apply(tree, audio, style, xt)
    u_t, v_t = tm.predict(*tm.precompute_cond(T(audio), T(style)), T(xt))
    np.testing.assert_allclose(N(u_t), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(N(v_t), np.asarray(v_j), atol=1e-5)
    rng = jax.random.PRNGKey(12)
    x0 = np.asarray(jax.random.normal(rng, (2, 13, ta.emb_dim), F32))
    want = jm.apply(tree, audio, style, rng, 3, method=JDiff.sample)
    np.testing.assert_allclose(N(tm.sample(T(audio), T(style), 3, x0=T(x0))), np.asarray(want),
                               atol=1e-4)

    rng_np = np.random.default_rng(3)
    B, L = 4, 24
    batch = (rng_np.random((B, L, 16), dtype=np.float32),
             rng_np.standard_normal((B, L, 6)).astype(np.float32),
             rng_np.standard_normal((B, 8)).astype(np.float32),
             rng_np.uniform(0, 10, (B, 5)).astype(np.float32))
    step_rng = jax.random.PRNGKey(4)
    (_, aux), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, step_rng, JBatch(*batch), JTrain()), has_aux=True))(tree)
    k_t, k_noise = jax.random.split(step_rng)
    t = T(stratified_logit_normal_t(k_t, B))
    x0 = T(jax.random.normal(k_noise, (B, L, 6), F32))
    loss, metrics = diffusion_loss(tm, LatentBatch(*map(T, batch)), DiffusionTrainArgs(), t=t,
                                   x0=x0)
    loss.backward()
    for name in ("loss", "osl", "del", "u_mape"):
        np.testing.assert_allclose(N(metrics[name]), np.asarray(aux[name]), rtol=1e-5,
                                   err_msg=name)
    _grads_match(tm, jgrad, 2e-5)


def _latent(package: str):
    if package == "jax":
        from osu_dreamer_tpu.models.latent.model import LatentModel, LatentModelArgs
        from osu_dreamer_tpu.utils import dataclass_from_dict
    else:
        from osu_dreamer_tpu_torch.models.latent.model import LatentModel, LatentModelArgs
        from osu_dreamer_tpu_torch.utils import dataclass_from_dict
    return LatentModel, dataclass_from_dict(LatentModelArgs, LATENT_R0)


def test_latent_model_radius0_matches_jax():
    """a radius-0 latent model (every FilmStack without its conv) from a
    radius-0 flax tree: encode_audio and decode (1e-4), and the gradient of
    a scalar of both through every leaf (2e-5 of the largest)"""
    JLatent, ja = _latent("jax")
    TLatent, ta = _latent("torch")
    spec = np.random.default_rng(0).random((2, 36, 72)).astype(np.float32)
    chart = np.random.default_rng(1).random((2, 36, 9)).astype(np.float32)
    jm = JLatent(ja, F32)
    tree = fill_tree(jm.init(KEY, spec, chart, method=JLatent.init_all), 6)
    assert not any("dw_" in k for k in _flatten(tree["params"]))
    tm = port(TLatent(ta, torch.float32), tree)
    z, s = randn(2, 2, 4, 4), randn(3, 2, 8)
    cot_c, cot_l = randn(4, 2, 36, 9), randn(5, 2, 5)

    def jax_fn(p):
        skips, _ = jm.apply(p, spec, method=JLatent.encode_audio)
        c, lab = jm.apply(p, z, s, skips=skips, method=JLatent.decode)
        return (c * cot_c).sum() + (lab * cot_l).sum(), (c, lab)

    (_, (chart_j, lab_j)), jgrad = jax.value_and_grad(jax_fn, has_aux=True)(tree)
    skips, _ = tm.encode_audio(T(spec))
    chart_t, lab_t = tm.decode(T(z), T(s), skips=skips)
    np.testing.assert_allclose(N(chart_t), np.asarray(chart_j), atol=1e-4)
    np.testing.assert_allclose(N(lab_t), np.asarray(lab_j), atol=1e-4)
    ((chart_t * T(cot_c)).sum() + (lab_t * T(cot_l)).sum()).backward()
    touched = {k for k, p in tm.named_parameters() if p.grad is not None}
    for _, p in tm.named_parameters():
        if p.grad is None:  # the chart encoder: no part of this function
            p.grad = torch.zeros_like(p)
    assert any(k.startswith("decoder") for k in touched)
    _grads_match(tm, jgrad, 2e-5)


def test_init_params_radius0_matches_flax_init():
    """``init_params`` at radius 0 against flax's init, the denoiser and
    the latent model: the same leaves (no conv), the same constants, the
    random leaves at lecun_normal's std; 8 random leaves a backbone layer
    (9 with the conv kernel)"""
    JDiff, ja = _diffusion("jax")
    TDiff, ta = _diffusion("torch")
    jtree = jax.jit(JDiff(ja, F32).init)(KEY, np.zeros((2, 24, 16)), np.zeros((2, 8)),
                                         np.zeros((2, 24, 6)))
    model = TDiff(ta, torch.float32).init_params(torch.Generator().manual_seed(0))
    assert _init_rule(jtree, model) == 19 - ja.backbone.depth
    JLatent, jla = _latent("jax")
    TLatent, tla = _latent("torch")
    jtree = jax.jit(lambda: JLatent(jla, F32).init(KEY, jnp.zeros((2, 18, 72)),
                                                   jnp.zeros((2, 18, 9)),
                                                   method=JLatent.init_all))()
    model = TLatent(tla, torch.float32).init_params(torch.Generator().manual_seed(0))
    assert _init_rule(jtree, model) > 0


def test_radius0_odt_loads_into_the_port(tmp_path):
    """an ``.odt`` the JAX package writes from a radius-0 LDM (denoiser and
    latent stacks without convs) loads through the port's
    ``load_inference`` with every leaf carried over exactly, and its tree
    round-trips through ``to_flax_params``"""
    from osu_dreamer_tpu.models.inference.artifact import build_artifact_bytes
    from osu_dreamer_tpu.models.inference.model import LDM, LDMArgs
    from osu_dreamer_tpu.utils import dataclass_from_dict
    from osu_dreamer_tpu_torch.models.inference.artifact import load_inference, to_flax_params
    from test_torch_modules import TINY_DIFFUSION as DIFFUSION, TINY_LATENT as LATENT, TINY_STYLE

    args = dataclass_from_dict(LDMArgs, {
        "latent": {**LATENT, "stack": {**LATENT["stack"], "radius": 0}}, "style": TINY_STYLE,
        "diffusion": {**DIFFUSION, "backbone": {**DIFFUSION["backbone"], "radius": 0}}})
    from osu_dreamer_tpu.models.latent.model import LatentModel

    labels, spec = np.array([[5, 9, 8, 4, 6]], np.float32), jnp.zeros((1, 18, 72))
    tree = LDM(args, F32).init(KEY, spec, labels, KEY, 1, 1)
    latent = LatentModel(args.latent, F32).init(KEY, spec, jnp.zeros((1, 18, 9)),
                                                method=LatentModel.init_all)
    tree = fill_tree({"params": {**tree["params"], "latent": latent["params"]}}, 9)
    path = tmp_path / "r0.odt"
    path.write_bytes(build_artifact_bytes(args, tree))
    tm = load_inference(path, "cpu")
    flat = {k: np.asarray(v) for k, v in _flatten(tree["params"]).items()}
    assert not any("dw_" in k for k in flat)
    sd = tm.state_dict()
    for key, value in sd.items():
        want = flat[key].transpose(3, 2, 0, 1) if value.ndim == 4 else flat[key]
        np.testing.assert_array_equal(N(value), want, err_msg=key)
    back = to_flax_params(tm)
    assert set(_flatten(back["params"])) == set(sd)
    again = from_flax_params(back, tm)
    assert all(torch.equal(again[k], v) for k, v in sd.items())


# ------------------------------------------------------------- unit tap ----


@pytest.mark.parametrize("film", [False, True])
def test_unit_tap_is_the_conv_free_function(film):
    """the plain versions with radius 0's unit tap (ones (1, C), zero bias)
    equal the conv-free function bit for bit in bf16: the output and the
    gradients of the input and the FFN's weights"""
    from osu_dreamer_tpu_torch.nn.norm import rms_norm
    from osu_dreamer_tpu_torch.ops import film_layer as fl
    from osu_dreamer_tpu_torch.ops import swiglu as sw

    rng = np.random.default_rng(int(film))
    B, L, C, H = 2, 11, 32, 42

    def bf(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            torch.bfloat16)

    x, go = bf(B, L, C), bf(B, L, C)
    w = [bf(C, 2 * H, scale=C ** -0.5), bf(2 * H, scale=0.1), bf(H, C, scale=H ** -0.5),
         bf(C, scale=0.1)]
    film_args = [bf(B, C, scale=0.3) for _ in range(3)] + [1 + bf(C, scale=0.1)] * 2
    tap = [torch.ones(1, C), torch.zeros(C)]

    def no_conv(y, vg_kernel, vg_bias, out_kernel, out_bias):
        vg = y @ vg_kernel + vg_bias
        v, g = vg.chunk(2, dim=-1)
        return rms_norm(v * torch.nn.functional.silu(g)) @ out_kernel + out_bias

    if film:
        def tapped(x, *w):
            return fl.film_layer_plain(x, *film_args, *tap, *w)

        def bare(x, *w):
            scale, shift, gate, g1, g2 = film_args
            return fl.film_out(x, no_conv(fl.film_in(x, scale, shift, g1), *w), gate, g2)
    else:
        def tapped(x, *w):
            return sw.swiglu_plain(x, *tap, *w)

        bare = no_conv
    got, want = tapped(x, *w), bare(x, *w)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    for a, b in zip(sw.grads_of(tapped, (x, *w), go), sw.grads_of(bare, (x, *w), go)):
        assert torch.equal(a, b)


# -------------------------------------------------------- sp 2 and tp 2 ----


def test_radius0_swiglu_exchanges_no_halo(monkeypatch):
    """under sp a radius-0 SwiGLU runs its shard as it is (no halo frames,
    no exchange); a radius-1 one asks for its halo"""
    import osu_dreamer_tpu_torch.nn.blocks as blocks

    asked = []

    def halo(x, radius, group):
        asked.append(radius)
        return torch.nn.functional.pad(x, (0, 0, radius, radius))

    monkeypatch.setattr(blocks, "halo_exchange", halo)
    x = torch.from_numpy(randn(0, 1, 6, 16))
    r0 = blocks.SwiGLU(16, 2, 0, torch.float32)
    torch.testing.assert_close(r0(x, sp=object()), r0(x), rtol=0, atol=0)
    assert asked == []
    blocks.SwiGLU(16, 2, 1, torch.float32)(x, sp=object())
    assert asked == [1]


def test_sp_step_radius0_matches_jax(tmp_path):
    """one step of a radius-0 denoiser at sp 2 (the u-head's radius-1 convs
    still exchange their halos) on two gloo ranks: each rank's loss terms
    equal the JAX unsharded ``diffusion_loss`` (1e-5 relative) and its
    averaged gradients the JAX gradients (2e-5 of the largest)"""
    from osu_dreamer_tpu.models.diffusion.train import DiffusionTrainArgs as JArgs
    from osu_dreamer_tpu.models.diffusion.train import LatentBatch as JBatch
    from osu_dreamer_tpu.models.diffusion.train import diffusion_loss as jloss
    from test_torch_parallel import spawn
    from test_torch_parallel_sp import _jax_case, _load, _step_rank

    jm, tree, tree_np, batch, step_rng, t, x0 = _jax_case(21, DIFFUSION_R0)
    (_, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloss(jm, p, step_rng, JBatch(*batch), JArgs()), has_aux=True))(tree)
    spawn(_step_rank, str(tmp_path), {"dp": 1}, tree_np, batch, t, x0, DIFFUSION_R0)
    ranks = _load(tmp_path, 2)
    want = {k: np.asarray(v) for k, v in _flatten(grads_j["params"]).items()}
    gmax = max(np.abs(g).max() for g in want.values())
    for got in ranks:
        assert set(got["grads"]) == set(want)
        for name in ("loss", "osl", "del", "u_mape"):
            np.testing.assert_allclose(got["metrics"][name].numpy(), np.asarray(aux_j[name]),
                                       rtol=1e-5, err_msg=name)
        for key, w in want.items():
            np.testing.assert_allclose(got["grads"][key].numpy(), w, atol=2e-5 * gmax,
                                       err_msg=key)


def test_tp_step_radius0_equals_one_process_and_jax(tmp_path):
    """one step of a radius-0 denoiser on two tensor-parallel ranks (the
    FFNs' TP forms with the unit tap) equals the port's one-process step and
    the JAX package's unsharded step, by ``_check_step``'s tolerances"""
    from test_torch_parallel import spawn
    from test_torch_parallel_tp import (
        B_DENOISER, _batch, _check_step, _init, _jax_denoiser, _step, _step_rank,
    )

    seed, grad_clip = 10, 1.0
    batch_np = _batch("denoiser", seed, B_DENOISER)
    whole, _, _ = _init("denoiser", None, seed, grad_clip, model=DIFFUSION_R0)
    draws_np, jax_metrics, jax_params, jax_grads = _jax_denoiser(
        whole.model.state_dict(), batch_np, grad_clip, 6, model=DIFFUSION_R0)
    spawn(_step_rank, str(tmp_path), "denoiser", {"tp": 2}, seed, grad_clip, batch_np, draws_np,
          None, DIFFUSION_R0)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["sharded"]
    ref = _step("denoiser", None, seed, grad_clip, batch_np, draws_np, model=DIFFUSION_R0)
    _check_step(ranks, ref, jax_metrics, jax_params, 3e-4 * 0.3, ("loss", "osl", "del"),
                jax_grads)
