"""The PyTorch port (osu_dreamer_tpu_torch) against the JAX package, module
by module, on the CPU in f32.

Every flax module is initialised for its tree structure, then EVERY leaf is
refilled from a numpy seed (``fill_tree``): flax zero-initialises the FiLM,
output and gate layers, and a comparison through zeros would be vacuous. The
same tree is carried into the port with ``from_flax_params``. Sampler noise
is drawn the way the JAX code draws it (same key, split and shape) and handed
to the port as ``s0``/``x0``.

Tolerances: both sides compute in f32 and differ only in the summation order
of their matrix products (XLA vs PyTorch CPU kernels), about 1e-6 relative
per product; each tolerance below leaves room for that error to grow through
the module's depth and, for the samplers, through their steps.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_dreamer_tpu_torch.models.inference.artifact import from_flax_params

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)
F32 = jnp.float32


def fill_tree(tree, seed: int):
    """every leaf of a flax param tree redrawn: fan-in scaled normal for
    kernels, 1 + 0.1 N for gains, 0.1 N for other vectors (the rule of the
    port's ``init_random``)"""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        n = rng.standard_normal(x.shape)
        if x.ndim >= 2:
            n = n / np.sqrt(np.prod(x.shape[:-1]))
        elif path[-1].key.endswith("gamma"):
            n = 1.0 + 0.1 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def port(module: torch.nn.Module, tree) -> torch.nn.Module:
    module.load_state_dict(from_flax_params(tree, module))
    return module.eval()


def T(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def N(x) -> np.ndarray:
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def randn(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- copies ----


def test_copied_constants_match_jax():
    from osu_dreamer_tpu.audio import constants as jc
    from osu_dreamer_tpu.audio import spectrogram as js
    from osu_dreamer_tpu.models.inference import sampler as jsampler
    from osu_dreamer_tpu.signal import encoding as je
    from osu_dreamer_tpu_torch.audio import constants as tc
    from osu_dreamer_tpu_torch.audio import spectrogram as ts
    from osu_dreamer_tpu_torch.models.inference import sampler as tsampler
    from osu_dreamer_tpu_torch.signal import constants as te

    for name in ("F_MIN", "BINS_PER_OCTAVE", "N_OCTAVES", "N_BINS", "A_DIM", "F_MAX", "SR",
                 "MS_PER_FRAME", "HOP_LEN"):
        assert getattr(tc, name) == getattr(jc, name), name
    np.testing.assert_array_equal(tc.resonator_freqs(), jc.resonator_freqs())
    for n in (0, 1, 20480):
        np.testing.assert_array_equal(tc.get_frame_times(n), jc.get_frame_times(n))
    assert ts.Q_FACTOR == js.Q_FACTOR and ts.WAVE_BUCKET == js.WAVE_BUCKET
    freqs = jc.resonator_freqs().astype(np.float64)
    np.testing.assert_array_equal(ts.resonator_alphas(freqs), js.resonator_alphas(freqs))
    for name in ("HIT_DIM", "CURSOR_DIM", "X_DIM", "NUM_LABELS"):
        assert getattr(te, name) == getattr(je, name), name
    assert (tsampler.XY_QRANGE, tsampler.XY_QSCALE) == (jsampler.XY_QRANGE, jsampler.XY_QSCALE)


def test_model_args_defaults_match_jax():
    """the port's config dataclasses are copies: same fields, same defaults
    (the full-width model chip_smoke.py runs is LDMArgs())"""
    from osu_dreamer_tpu.models.inference.model import LDMArgs as JArgs
    from osu_dreamer_tpu_torch.models.inference.model import LDMArgs as TArgs

    assert dataclasses.asdict(TArgs()) == dataclasses.asdict(JArgs())
    for part in ("latent", "style", "diffusion"):
        for prop in ("chunk_size", "c0", "u_scale", "d0_sq"):
            if hasattr(getattr(JArgs(), part), prop):
                assert getattr(getattr(TArgs(), part), prop) == getattr(getattr(JArgs(), part), prop)


def test_prep_wave_matches_jax():
    from osu_dreamer_tpu.audio.spectrogram import prep_wave_for_model as jprep
    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model as tprep

    for wave in (randn(0, 5000, scale=0.3), randn(1, 123457, scale=2.0), np.zeros(0, np.float32)):
        got, want = tprep(wave, 27), jprep(wave, 27)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("features", [16, 32, 64, 128, 256])
def test_rff_tables_match_jax(features):
    """the committed unit draws equal jax.random's, and fourier_features
    agrees (cos of the same f32 argument: 1e-6)"""
    from osu_dreamer_tpu.nn.features import _RFF_SEED
    from osu_dreamer_tpu.nn.features import fourier_features as jff
    from osu_dreamer_tpu_torch.nn.features import _unit_tables
    from osu_dreamer_tpu_torch.nn.features import fourier_features as tff

    kw, kb = jax.random.split(jax.random.PRNGKey(_RFF_SEED))
    W, b = _unit_tables(1, features, torch.device("cpu"))
    np.testing.assert_array_equal(N(W), np.asarray(jax.random.normal(kw, (1, features), F32)))
    np.testing.assert_array_equal(
        N(b), np.asarray(jax.random.uniform(kb, (features,), F32, -jnp.pi, jnp.pi))
    )
    x = np.random.default_rng(features).uniform(-1, 1, (3, 5, 1)).astype(np.float32)
    np.testing.assert_allclose(N(tff(T(x), features, 32)), np.asarray(jff(x, features, 32)),
                               atol=1e-5)


# --------------------------------------------------------------- modules ----


def test_rms_norm_module():
    from osu_dreamer_tpu.nn.norm import RMSNorm as JNorm
    from osu_dreamer_tpu_torch.nn.norm import RMSNorm as TNorm

    x = randn(0, 2, 7, 12, scale=3.0)
    tree = fill_tree(JNorm(12).init(KEY, x), 1)
    got = port(TNorm(12), tree)(T(x))
    np.testing.assert_allclose(N(got), np.asarray(JNorm(12).apply(tree, x)), atol=1e-6)


@pytest.mark.parametrize("radius", [1, 2])
def test_swiglu_module(radius):
    from osu_dreamer_tpu.nn.blocks import SwiGLU as JSwiGLU
    from osu_dreamer_tpu_torch.nn.blocks import SwiGLU as TSwiGLU

    x = randn(0, 2, 29, 16)
    jm = JSwiGLU(16, 2, radius, dtype=F32)
    tree = fill_tree(jm.init(KEY, x), 2)
    got = port(TSwiGLU(16, 2, radius, torch.float32), tree)(T(x))
    np.testing.assert_allclose(N(got), np.asarray(jm.apply(tree, x)), atol=1e-5)


@pytest.mark.parametrize("cond_dim", [0, 8])
def test_filmstack_module(cond_dim):
    from osu_dreamer_tpu.nn.blocks import FilmStack as JStack
    from osu_dreamer_tpu_torch.nn.blocks import FilmStack as TStack

    x = randn(0, 3, 31, 16)
    cond = randn(1, 3, cond_dim) if cond_dim else None
    jm = JStack(16, cond_dim, 2, expand=2, radius=2, dtype=F32)
    tree = fill_tree(jm.init(KEY, x, cond), 3)
    tm = port(TStack(16, cond_dim, 2, 2, 2, torch.float32), tree)
    got = tm(T(x), None if cond is None else T(cond))
    np.testing.assert_allclose(N(got), np.asarray(jm.apply(tree, x, cond)), atol=1e-5)


def test_rope_attention_film_add():
    from osu_dreamer_tpu.nn.attention import RoPEAttention as JAttn
    from osu_dreamer_tpu_torch.nn.attention import RoPEAttention as TAttn

    x, add = randn(0, 2, 37, 24), randn(1, 2, 37, 24)
    film = (randn(2, 2, 24, scale=0.3), randn(3, 2, 24, scale=0.3))
    jm = JAttn(n_heads=2, head_dim=8, out_dim=20, dtype=F32)
    tree = fill_tree(jm.init(KEY, x, film=film, add=add), 4)
    tm = port(TAttn(24, 2, 8, 20, torch.float32), tree)
    got = tm(T(x), film=(T(film[0]), T(film[1])), add=T(add))
    np.testing.assert_allclose(N(got), np.asarray(jm.apply(tree, x, film=film, add=add)),
                               atol=1e-5)


def test_spec_features_module():
    from osu_dreamer_tpu.models.latent.model import SpecFeatures as JSpec
    from osu_dreamer_tpu_torch.models.latent.model import SpecFeatures as TSpec

    spec = np.random.default_rng(0).random((2, 27, 72)).astype(np.float32)
    jm = JSpec(16, F32)
    tree = fill_tree(jm.init(KEY, spec), 5)
    got = port(TSpec(16, torch.float32), tree)(T(spec))
    np.testing.assert_allclose(N(got), np.asarray(jm.apply(tree, spec)), atol=1e-5)


TINY_LATENT = dict(emb_dim=4, style_dim=8, n_downs=2, stride=3, h_dim=16,
                   stack=dict(n_layers=1, expand=2, radius=2), style_head_dim=8, style_heads=2)
TINY_STYLE = dict(style_dim=8, label_features=16, h_dim=16, depth=2, expand=2)
TINY_DIFFUSION = dict(emb_dim=4, a_dim=16, style_dim=8, global_cond_dim=16, backbone_dim=16,
                      u_head_dim=8,
                      backbone=dict(depth=2, expand=2, head_dim=8, n_heads=2, radius=2))


def tiny_args(package: str):
    """the tiny LDMArgs (the e2e test's TINY_*_CFG model blocks, with two
    layers where one would leave the stacks' layer loop untested) of
    ``package``"""
    if package == "jax":
        from osu_dreamer_tpu.models.inference.model import LDMArgs
        from osu_dreamer_tpu.utils import dataclass_from_dict
    else:
        from osu_dreamer_tpu_torch.models.inference.model import LDMArgs
        from osu_dreamer_tpu_torch.utils import dataclass_from_dict
    return dataclass_from_dict(
        LDMArgs, {"latent": TINY_LATENT, "style": TINY_STYLE, "diffusion": TINY_DIFFUSION}
    )


def test_latent_encode_audio_and_decode():
    from osu_dreamer_tpu.models.latent.model import LatentModel as JLatent
    from osu_dreamer_tpu_torch.models.latent.model import LatentModel as TLatent

    ja, ta = tiny_args("jax").latent, tiny_args("torch").latent
    spec = np.random.default_rng(0).random((2, 36, 72)).astype(np.float32)
    chart = np.random.default_rng(1).random((2, 36, 9)).astype(np.float32)
    jm = JLatent(ja, F32)
    tree = fill_tree(jm.init(KEY, spec, chart, method=JLatent.init_all), 6)
    tm = port(TLatent(ta, torch.float32), tree)

    skips_j, h_j = jm.apply(tree, spec, method=JLatent.encode_audio)
    skips_t, h_t = tm.encode_audio(T(spec))
    np.testing.assert_allclose(N(h_t), np.asarray(h_j), atol=1e-4)
    for a, b in zip(skips_t, skips_j):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-4)

    # decode 4 rows against the S=2 skips broadcast/repeated as the LDM does
    z, s = randn(2, 2, 4, 4), randn(3, 2, 8)
    chart_j, lab_j = jm.apply(tree, z, s, skips=skips_j, method=JLatent.decode)
    chart_t, lab_t = tm.decode(T(z), T(s), skips=[T(np.asarray(k)) for k in skips_j])
    np.testing.assert_allclose(N(chart_t), np.asarray(chart_j), atol=1e-4)
    np.testing.assert_allclose(N(lab_t), np.asarray(lab_j), atol=1e-4)


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_style_sample(guidance):
    """sphere tracing over 4 steps on the noise the JAX sampler draws; the
    labels include a negative entry (the learned null row)"""
    from osu_dreamer_tpu.models.style.model import StyleModel as JStyle
    from osu_dreamer_tpu_torch.models.style.model import StyleModel as TStyle

    ja, ta = tiny_args("jax").style, tiny_args("torch").style
    labels = np.array([[5, 9, 8, 4, 6], [3, -1, 5, 4, 4], [7, 8, 9, 5, 2]], np.float32)
    jm = JStyle(ja, F32)
    tree = fill_tree(jm.init(KEY, randn(0, 3, 8), labels), 7)
    tm = port(TStyle(ta, torch.float32), tree)

    u_j, v_j = jm.apply(tree, randn(1, 3, 8), labels)
    u_t, v_t = tm(T(randn(1, 3, 8)), T(labels))
    np.testing.assert_allclose(N(u_t), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(N(v_t), np.asarray(v_j), atol=1e-5)

    rng = jax.random.PRNGKey(11)
    s0 = np.asarray(jax.random.normal(rng, (3, ta.style_dim), F32))
    want = jm.apply(tree, labels, rng, 4, guidance, method=JStyle.sample)
    got = tm.sample(T(labels), 4, guidance, s0=T(s0))
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-4)


def test_diffusion_predict_and_sample():
    from osu_dreamer_tpu.models.diffusion.model import DiffusionModel as JDiff
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel as TDiff

    ja, ta = tiny_args("jax").diffusion, tiny_args("torch").diffusion
    audio, style, xt = randn(0, 1, 13, 16), randn(1, 3, 8), randn(2, 3, 13, 4)
    jm = JDiff(ja, F32)
    tree = fill_tree(jm.init(KEY, audio, style, xt), 8)
    tm = port(TDiff(ta, torch.float32), tree)

    u_j, v_j = jm.apply(tree, audio, style, xt)
    a_c, c_g = tm.precompute_cond(T(audio), T(style))
    u_t, v_t = tm.predict(a_c, c_g, T(xt))
    np.testing.assert_allclose(N(u_t), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(N(v_t), np.asarray(v_j), atol=1e-5)

    rng = jax.random.PRNGKey(12)
    x0 = np.asarray(jax.random.normal(rng, (3, 13, ta.emb_dim), F32))
    want = jm.apply(tree, audio, style, rng, 3, method=JDiff.sample)
    got = tm.sample(T(audio), T(style), 3, x0=T(x0))
    np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-4)
