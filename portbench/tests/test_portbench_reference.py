"""The plain reference imports nothing of the program, and computes the
program's functions: with the program run in float32 on the CPU at a tiny
size, the two agree to float32 rounding, stage by stage and for a train
step's loss and gradients."""

from __future__ import annotations

import ast

import pytest
import torch
from conftest import ROOT, tiny

from portbench import traffic
from portbench.bench import benchmark, resolve
from portbench.drivers.predict_batch import ldm_args
from portbench.reference import chain
from portbench.reference import model as M
from portbench.reference.numerics import Numerics, fp8
from portbench.reference.spectrogram import spec_for_model
from portbench.weights import draw_state

BENCH = benchmark(ROOT)
F32 = Numerics("f32")


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("osu_dreamer_tpu_torch", "osu_dreamer_tpu",
                                                  "jax", "flax", "portbench"), (path, name)


def _close(a, b, tol=2e-5):
    a, b = a.float(), b.float()
    assert float((a - b).norm() / b.norm().clamp_min(1e-12)) < tol


@pytest.fixture(scope="module")
def ldm():
    from osu_dreamer_tpu_torch.models.inference.model import LDM

    cell = tiny(resolve(BENCH, "predict.mapset-120s"))
    model = LDM(ldm_args(cell.cfg), torch.float32).eval()
    W = draw_state({k: tuple(v.shape) for k, v in model.state_dict().items()}, 3, "cpu",
                   cell.cfg["damped"])
    model.load_state_dict(W)
    return cell, model, W


@torch.no_grad()
def test_mapset_chain_matches_the_program_in_f32(ldm):
    from osu_dreamer_tpu_torch.audio.spectrogram import spec_for_model_batch
    from osu_dreamer_tpu_torch.models.inference.sampler import (
        build_batch_sampler, dequantize_chart,
    )

    cell, model, W = ldm
    cfg, wl = cell.cfg, cell.wl
    songs = traffic.songs(wl, 3, 0, 27, "cpu")
    labels = traffic.labels(wl, 3, 0, "cpu")
    args = (songs["waves"], songs["real_frames"], songs["n_frames"], songs["out_frames"])
    _close(spec_for_model_batch(*args), spec_for_model(*args), 1e-5)
    S, D = labels.shape[:2]
    s0, x0 = traffic.sampler_noise(cfg, S * D, songs["out_frames"] // 27, 3, 0, "cpu")
    smp = cfg["sampling"]
    hit, xy, lab = build_batch_sampler(model)(songs["waves"], songs["real_frames"], labels, None,
                                              songs["n_frames"], songs["out_frames"],
                                              smp["steps"], smp["guidance"], s0=s0, x0=x0)
    chart, ref_labels = chain.mapset_batch(W, cfg, songs["waves"], songs["real_frames"], labels,
                                           s0, x0, songs["n_frames"], songs["out_frames"],
                                           smp["steps"], smp["style_steps"], smp["guidance"], F32)
    _close(torch.from_numpy(dequantize_chart(hit.numpy(), xy.numpy())),
           torch.from_numpy(chart), 1e-3)  # a few charts' values cross a quantization step
    _close(lab, torch.from_numpy(ref_labels))


def test_train_step_matches_the_program_in_f32():
    from osu_dreamer_tpu_torch.models.diffusion.model import (
        BackboneArgs, DiffusionModel, DiffusionModelArgs,
    )
    from osu_dreamer_tpu_torch.models.diffusion.train import (
        DiffusionTrainArgs, LatentBatch, diffusion_loss,
    )

    cell = tiny(resolve(BENCH, "train.denoiser-l152"))
    d = dict(cell.cfg["diffusion"], backbone=BackboneArgs(**cell.cfg["diffusion"]["backbone"]))
    model = DiffusionModel(DiffusionModelArgs(**d), torch.float32)
    W = draw_state({"diffusion." + k: tuple(v.shape) for k, v in model.state_dict().items()}, 4,
                   "cpu", cell.cfg["damped"])
    model.load_state_dict({k[len("diffusion."):]: v for k, v in W.items()})
    h, z, s, lab = traffic.latent_batches(cell.cfg, cell.wl, 4, "cpu")[0]
    t, x0 = traffic.train_noise(cell.cfg, 4, 16, 4, 0, "cpu")
    loss, _ = diffusion_loss(model, LatentBatch(h, z, s, lab), DiffusionTrainArgs(), t=t, x0=x0)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ref = chain.train_steps(W, cell.cfg, [(h, z, s)], [(t, x0)], F32)
    assert float(loss) == pytest.approx(ref["loss"][0], rel=1e-5)
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    scale = min(1.0, cell.cfg["train"]["opt"]["grad_clip"] / float(norm))
    for (name, _), g in zip(model.named_parameters(), grads):
        _close(g * scale, ref["grad"]["diffusion." + name], 1e-4)


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.linspace(-3.0, 3.0, 1001)
    q = fp8(t)
    assert float((q - t).abs().max()) <= 3.0 / 448 * 16 * 1.001  # half a step, top binade
    assert float((q - t).abs().max()) > 1e-3
    assert torch.equal(Numerics("f32").mm(t[None], t[:, None]), t[None] @ t[:, None])
