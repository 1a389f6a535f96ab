"""The chart WAE cell's pieces on the CPU: the plain reference (reference/wae.py)
computes the program's chart encoder and training step, with the program
run in float32 at the cell's CPU cut and the same draws injected; the
traffic is a function of the seed; the work counts add up by hand."""

from __future__ import annotations

import pytest
import torch
from conftest import ROOT, tiny

from portbench import wae_traffic
from portbench.bench import benchmark, resolve
from portbench.latent_work import chart_encode_flops, film_layer_bwd_work, latent_train_flops
from portbench.reference import wae
from portbench.roofline import latent_decode_flops, latent_encode_flops
from portbench.weights import draw_state

CELL = "train.latent-b32"
F32 = wae.TrainNumerics("f32")


def _gap(a, b, floor: float = 1e-12) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(floor))


@pytest.fixture(scope="module")
def program():
    """the cut cell, the port's f32 state at the benchmark's weights, a batch
    and its draws"""
    from osu_dreamer_tpu_torch.models.latent.model import LatentModelArgs, StackArgs
    from osu_dreamer_tpu_torch.models.latent.train import (
        Batch, LatentDraws, LatentTrainArgs, init_latent_training,
    )
    from osu_dreamer_tpu_torch.nn.schedule import LRScheduleArgs
    from osu_dreamer_tpu_torch.train.state import OptimizerArgs

    cell = tiny(resolve(benchmark(ROOT), CELL))
    lat, tr = cell.cfg["latent"], cell.cfg["train"]
    opt = OptimizerArgs(**dict(tr["opt"], schedule=LRScheduleArgs(**tr["opt"]["schedule"])))
    args = LatentTrainArgs(opt=opt, **{k: v for k, v in tr.items() if k != "opt"})
    state, step = init_latent_training(LatentModelArgs(**dict(lat, stack=StackArgs(**lat["stack"]))),
                                       args, 0, "cpu", torch.float32)
    W = draw_state({"latent." + k: tuple(v.shape) for k, v in state.model.state_dict().items()},
                   9, "cpu", cell.cfg["damped"])
    state.model.load_state_dict({k[len("latent."):]: v for k, v in W.items()})
    batch = wae_traffic.windows(cell.wl, 9, "cpu")[0]
    draws = wae_traffic.draws(cell.cfg, cell.wl, 9, 0, "cpu")
    return cell, state, step, W, Batch(*batch), LatentDraws(*draws)


@torch.no_grad()
def test_encode_chart_matches_the_program_in_f32(program):
    cell, state, _, W, batch, _ = program
    chart = wae.split_halves(batch.chart)
    z, s = state.model.encode_chart(chart)
    rz, rs = wae.encode_chart(W, cell.cfg, chart, F32)
    assert z.shape == rz.shape == (2 * cell.wl["batch"], 2, 6) and s.shape == rs.shape
    assert _gap(z, rz) < 2e-5 and _gap(s, rs) < 2e-5


def test_a_train_step_matches_the_program_in_f32(program):
    from osu_dreamer_tpu_torch.models.latent.train import LOSS_COMPONENTS

    from portbench.drivers.latent_step import NUMBERS

    assert NUMBERS == (*LOSS_COMPONENTS, "s_reg")
    cell, state, step, W, batch, draws = program
    metrics = step(state, batch, draws)
    ref = wae.train_steps(W, cell.cfg, [tuple(batch)], [tuple(draws)], F32)
    got = [float(metrics[k]) for k in NUMBERS]
    want = ref["components"][0] + ref["s_reg"]
    assert got == pytest.approx(want, rel=1e-5)
    # a leaf whose gradient is zero but for rounding (AttnPool's score bias,
    # under a softmax that no shift moves; the audio encoder's last
    # downsample) is held to 1e-3 of the median leaf's norm
    grads = {k: g.double().norm() for k, g in ref["grad"].items()}
    floor = 1e-3 * float(torch.stack(list(grads.values())).median())
    names = [k for k, _ in state.model.named_parameters()]
    for name, mu in zip(names, state.opt.mu):
        g = mu / (1.0 - state.opt.b1)
        assert _gap(g, ref["grad"]["latent." + name], floor) < 1e-4, name


def test_the_control_takes_gradients_through_the_spectrogram_stem():
    x = torch.rand(2, 1, 12, 72)
    w = torch.randn(8, 1, 3, 8, requires_grad=True)
    for kind in ("f32", "fp8"):
        y = wae.TrainNumerics(kind).conv2d(x, w, (1, 6), (1, 1))
        (g,) = torch.autograd.grad(y.square().sum(), [w])
        assert y.shape == (2, 8, 12, 12) and bool(g.abs().sum() > 0)


def test_the_control_holds_in_fp8_what_the_program_holds_in_bf16():
    from portbench.reference.numerics import E5M2, Numerics, fp8

    a, b = torch.randn(3, 16), torch.randn(16, 8)
    x = torch.randn(4, 8, requires_grad=True)
    assert wae.TrainNumerics("f32").hold(x) is x
    held = wae.TrainNumerics("fp8")
    assert torch.equal(held.hold(x), fp8(x))
    grad = torch.randn(4, 8)
    (g,) = torch.autograd.grad(held.hold(x), [x], grad)
    assert torch.equal(g, fp8(grad, E5M2))
    assert torch.equal(Numerics("fp8").mm(a, b), fp8(a) @ fp8(b))
    assert torch.equal(held.mm(a, b), fp8(fp8(a) @ fp8(b)))


def test_the_traffic_repeats_by_seed_and_stays_in_range():
    cell = tiny(resolve(benchmark(ROOT), CELL))
    a = wae_traffic.windows(cell.wl, 2**31 + 7, "cpu")
    b = wae_traffic.windows(cell.wl, 2**31 + 7, "cpu")
    c = wae_traffic.windows(cell.wl, 2**31 + 8, "cpu")
    assert len(a) == cell.wl["pool"] and all(torch.equal(x, y) for p, q in zip(a, b)
                                              for x, y in zip(p, q))
    assert not torch.equal(a[0][1], c[0][1]) and not torch.equal(a[0][1], a[1][1])
    audio, chart, labels = a[0]
    B, L = cell.wl["batch"], cell.wl["seq_len"]
    assert audio.shape == (B, L, 72) and chart.shape == (B, L, 9) and labels.shape == (B, 5)
    for t, hi in ((audio, 1.0), (chart, 1.0), (labels, 10.0)):
        assert bool((t >= 0).all() and (t <= hi).all())
    assert torch.equal(torch.round(audio * 255), audio * 255)
    d1 = wae_traffic.draws(cell.cfg, cell.wl, 5, 1, "cpu")
    d2 = wae_traffic.draws(cell.cfg, cell.wl, 5, 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(d1, d2))
    assert [tuple(t.shape) for t in d1] == [(4, 32), (4, 32), (4, 2, 6), (4,), (4, 32), (4,), (4,)]


def test_k3_work_at_the_latent_levels():
    # B64 L1026 C128, H = int(128 * 4 * 2 / 3) = 341, 5 taps: 6 C x H products
    # and two conv passes a row, two operations a multiply-add
    rows = 64 * 1026
    flops, nbytes = film_layer_bwd_work(64, 1026, 128, 341, 5)
    assert flops == rows * 2 * (6 * 128 * 341 + 2 * 5 * 128)
    weights = 5 * 128 + 128 + 128 * 682 + 682 + 341 * 128 + 128 + 2 * 128
    assert nbytes == 2 * (3 * rows * 128 + 6 * 64 * 128 + 2 * weights)


def test_the_step_flops_add_up():
    cfg = resolve(benchmark(ROOT), CELL).cfg
    lat = cfg["latent"]
    R, L, C, H = 64, 1026, 128, 341
    ffn = 2 * 3 * C * H                                     # a FiLM layer's products a row
    film = 2 * R * 32 * 3 * C                               # a conditioned layer's FiLM vectors
    levels = R * (L + L // 3 + L // 9)                      # rows of a U-Net's three stacks
    chart = 2 * R * L * 9 * C + 8 * ffn * levels + 8 * ffn * R * 38 * 2 + 8 * film \
        + 2 * R * 38 * (C * 16 + C * 1024 + 1024) + 2 * R * 1024 * 32 + 2 * R * 38 * C * 6
    assert chart_encode_flops(lat, R, L) == chart
    assert latent_train_flops(cfg, 32, 2052) == 3 * (chart + latent_encode_flops(lat, R, L)
                                                     + latent_decode_flops(lat, R, L))
    assert 1.5e12 < latent_train_flops(cfg, 32, 2052) < 2.5e12
