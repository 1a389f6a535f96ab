"""The port runs where the machine with the card runs it: without jax, flax,
jaxtyping, click, msgpack, yaml or the JAX package.

A subprocess makes each of those unimportable, imports every module of
osu_dreamer_tpu_torch (the inference slice and the training modules:
train/, data/ with the dataset build, ops/, signal/ with its encode side,
models/diffusion/, models/latent/, models/style/, serve/ with its HTTP front
end, cli), drives a tiny slice
(init_random weights, two songs x two difficulties, CFG on) through
``build_batch_sampler`` on the CPU, runs ``run_predict`` on one WAV to an
.osz (in-process serialization), trains a tiny denoiser and a tiny chart
autoencoder for two steps each through their ``fit.run`` (configs as dicts:
reading YAML needs yaml), runs encode-latents on the latter's checkpoint,
builds a dataset from a synthetic library (``generate_data``), trains a tiny
style prior for two steps, takes one attention forward and backward
through the fused prologue (ops/film_qkv.py, OSU_DREAMER_FUSED_PROLOGUE=1),
resolves a data-parallel and a tensor-parallel config (parallel/, with
parallel/tp.py's slices of a tiny denoiser) and runs ring attention and the
halo exchange (ops/ring_attention.py) on one rank.
The ``.odt`` reader and writer need msgpack, which is blocked here; they are
exercised by tests/test_torch_export.py and on the card by chip_smoke.py, and
so is the serving service, which loads a ``.odt`` (tests/test_torch_serve.py).
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ("jax", "flax", "jaxtyping", "click", "msgpack", "yaml", "osu_dreamer_tpu")

SCRIPT = textwrap.dedent(
    f"""
    import sys
    for name in {BLOCKED!r}:
        sys.modules[name] = None  # any import of it now raises ImportError

    import importlib, pkgutil
    import numpy as np
    import torch
    import osu_dreamer_tpu_torch

    torch.set_num_threads(1)
    names = [m.name for m in pkgutil.walk_packages(
        osu_dreamer_tpu_torch.__path__, "osu_dreamer_tpu_torch.")]
    for name in names:
        importlib.import_module(name)

    from osu_dreamer_tpu_torch.audio.spectrogram import prep_wave_for_model
    from osu_dreamer_tpu_torch.models.inference.artifact import init_random
    from osu_dreamer_tpu_torch.models.inference.model import LDMArgs
    from osu_dreamer_tpu_torch.models.inference.sampler import build_batch_sampler
    from osu_dreamer_tpu_torch.utils import dataclass_from_dict

    args = dataclass_from_dict(LDMArgs, {{
        "latent": {{"emb_dim": 4, "style_dim": 8, "n_downs": 2, "h_dim": 16,
                    "stack": {{"n_layers": 1, "expand": 2, "radius": 1}}}},
        "style": {{"style_dim": 8, "label_features": 16, "h_dim": 16, "depth": 1, "expand": 2}},
        "diffusion": {{"emb_dim": 4, "a_dim": 16, "style_dim": 8, "global_cond_dim": 16,
                       "backbone_dim": 16, "u_head_dim": 8,
                       "backbone": {{"depth": 1, "expand": 2, "head_dim": 8, "n_heads": 2,
                                     "radius": 1}}}},
    }})
    gen = torch.Generator().manual_seed(0)
    model = init_random(args, gen, "cpu")
    rng = np.random.default_rng(0)
    preps = [prep_wave_for_model(rng.normal(size=n).astype(np.float32) * 0.3, 9)
             for n in (30000, 60000)]
    waves = torch.from_numpy(np.stack([p[0] for p in preps]))
    real = torch.tensor([p[1] for p in preps])
    labels = torch.tensor([[5.0, 9, 8, 4, 6], [3, 5, 5, 4, 4]])
    hit, xy, lab = build_batch_sampler(model)(
        waves, real, labels, gen, preps[0][2], preps[0][3], 2, 2.0)
    assert hit.shape == (4, preps[0][3], 7) and hit.dtype == torch.uint8
    assert xy.shape == (4, preps[0][3], 2) and xy.dtype == torch.int16
    assert lab.shape == (4, 5) and bool(torch.isfinite(lab).all())
    import os
    import tempfile
    import wave
    import zipfile
    from pathlib import Path
    from osu_dreamer_tpu_torch.cli import run_predict

    with tempfile.TemporaryDirectory() as tmp:
        song = Path(tmp) / "song.wav"
        with wave.open(str(song), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(44100)
            w.writeframes((rng.normal(size=(2 * 44100, 2)) * 3000).astype("<i2").tobytes())
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            done = run_predict(model, [song], [[5.0, 9, 8, 4, 6]], 2, seed=0,
                               serialize_workers=1, device="cpu")
        finally:
            os.chdir(cwd)
        with zipfile.ZipFile(done[0].osz) as z:
            members = z.namelist()
        assert len(done) == 1 and "song.wav" in members, members
        assert sum(n.endswith(".osu") for n in members) == 1, members
    from osu_dreamer_tpu_torch.data.synth import write_latent_corpus
    from osu_dreamer_tpu_torch.models.diffusion.fit import run

    with tempfile.TemporaryDirectory() as tmp:
        write_latent_corpus(Path(tmp) / "data", 3, 2, 60, 16, 4, 8)
        state = run({{
            "data": {{"data_dir": str(Path(tmp) / "data"), "seq_len": 24, "batch_size": 2,
                      "max_per_map": -1}},
            "fit": {{"run_dir": str(Path(tmp) / "runs"), "max_steps": 2}},
            "train": {{"val_batches": 2}},
            "model": {{"emb_dim": 4, "a_dim": 16, "style_dim": 8, "global_cond_dim": 16,
                       "backbone_dim": 128, "u_head_dim": 8,
                       "backbone": {{"depth": 1, "expand": 2, "head_dim": 64, "n_heads": 2,
                                     "radius": 1}}}},
        }}, device="cpu")
        assert state.step == 2 and (Path(tmp) / "runs" / "last" / "state.pt").exists()

        from osu_dreamer_tpu_torch.data.synth import write_signal_corpus
        from osu_dreamer_tpu_torch.models.latent.encode import encode_latents
        from osu_dreamer_tpu_torch.models.latent.fit import run as run_latent

        write_signal_corpus(Path(tmp) / "signals", 3, 2, 80)
        state = run_latent({{
            "data": {{"data_dir": str(Path(tmp) / "signals"), "seq_len": 36, "batch_size": 2,
                      "max_per_map": -1}},
            "fit": {{"run_dir": str(Path(tmp) / "latent"), "max_steps": 2,
                     "monitor": "eval/score", "monitor_mode": "max"}},
            "model": {{"emb_dim": 4, "style_dim": 8, "n_downs": 2, "h_dim": 16,
                       "stack": {{"n_layers": 1, "expand": 2, "radius": 1}},
                       "style_head_dim": 8, "style_heads": 2}},
        }}, device="cpu")
        assert state.step == 2 and (Path(tmp) / "latent" / "best" / "state.pt").exists()
        assert encode_latents(Path(tmp) / "latent" / "best", Path(tmp) / "signals",
                              device="cpu") == 6

        from osu_dreamer_tpu_torch.cli import generate_data
        from osu_dreamer_tpu_torch.data.synth import build_library
        from osu_dreamer_tpu_torch.models.style.fit import run as run_style

        build_library(Path(tmp) / "Songs", 2, seconds=6.0)
        assert generate_data(Path(tmp) / "built", songs_dir=Path(tmp) / "Songs",
                             device="cpu") == 6
        state = run_style({{
            "data": {{"data_dir": str(Path(tmp) / "data"), "batch_size": 2}},
            "fit": {{"run_dir": str(Path(tmp) / "style"), "max_steps": 2,
                     "monitor": "val/energy_dist"}},
            "model": {{"style_dim": 8, "label_features": 16, "h_dim": 16, "depth": 1,
                       "expand": 2}},
        }}, device="cpu")
        assert state.step == 2 and (Path(tmp) / "style" / "best" / "state.pt").exists()

    import os
    from osu_dreamer_tpu_torch.nn import attention

    assert "osu_dreamer_tpu_torch.ops.film_qkv" in names
    assert {{"osu_dreamer_tpu_torch.serve.service", "osu_dreamer_tpu_torch.serve.http"}} <= set(names)
    parallel = {{"osu_dreamer_tpu_torch.parallel." + m
                for m in ("config", "distributed", "mesh", "collectives", "tp")}}
    assert parallel | {{"osu_dreamer_tpu_torch.ops.ring_attention"}} <= set(names)
    from osu_dreamer_tpu_torch.ops.ring_attention import halo_exchange, ring_attention
    from osu_dreamer_tpu_torch.parallel import ParallelArgs, build_parallelism

    par = build_parallelism(ParallelArgs(dp=2), 8, ["cpu", "cpu"])
    assert par.world_size == 2 and par.needs_launch
    par = build_parallelism(ParallelArgs(tp=2), 8, ["cpu", "cpu"])
    assert (par.world_size, par.tp, par.n_data) == (2, 2, 1) and par.needs_launch
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel, DiffusionModelArgs
    from osu_dreamer_tpu_torch.parallel.tp import shard_model

    net = DiffusionModel(dataclass_from_dict(DiffusionModelArgs, {{
        "a_dim": 16, "style_dim": 8, "global_cond_dim": 16, "backbone_dim": 32,
        "backbone": {{"depth": 1, "expand": 2, "n_heads": 2}}}}), torch.float32)
    layout = shard_model(net, None, 1, 2)
    assert net.net.layer0.attn.qkv.kernel.shape == (32, 3 * 64)
    assert net.net.layer0.ffn.out_kernel.shape == (21, 32) and len(layout.splits) == 6
    qkv = [torch.randn(2, 6, 2, 8, generator=gen, requires_grad=True) for _ in range(3)]
    ring_attention(*qkv, None).square().sum().backward()
    assert halo_exchange(torch.ones(1, 4, 2), 2, None).shape == (1, 8, 2)
    os.environ["OSU_DREAMER_FUSED_PROLOGUE"] = "1"
    seen = []
    dispatch = attention.film_qkv
    attention.film_qkv = lambda *a: seen.append(1) or dispatch(*a)
    attn = attention.RoPEAttention(128, 2, 64, 32, torch.float32)
    attn.qkv.reset_parameters(gen)
    xa = torch.randn(2, 10, 128, generator=gen, requires_grad=True)
    film = (torch.zeros(2, 128), torch.zeros(2, 128))
    attn(xa, film=film).square().sum().backward()
    assert seen == [1] and bool(torch.isfinite(xa.grad).all())
    blocked = [m for m in {BLOCKED!r} if sys.modules.get(m) is not None]
    assert not blocked, blocked
    print("imported", len(names), "modules")
    """
)


def test_port_runs_without_jax_stack():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "imported" in proc.stdout
