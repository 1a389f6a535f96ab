"""A run whose timed path is broken underneath reads ``correct`` false: each
fault a cell can have, planted in the program at a tiny size on the CPU,
driven through the rest of a run (``run_cell``) and judged by the cell's
own limits. The same tiny run without a fault reads correct."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import CELLS, ROOT, tiny

from portbench.bench import benchmark, resolve
from portbench.run import run_cell


def _unchanged_train(monkeypatch):
    """a step that returns the state unchanged: no update, no EMA"""
    from osu_dreamer_tpu_torch.models.diffusion import train
    from osu_dreamer_tpu_torch.train import state

    monkeypatch.setattr(state.AdamW, "step", lambda self, grads, norm=None: torch.zeros(()))
    monkeypatch.setattr(train, "ema_update", lambda *a, **k: None)


def _half_batch_train(monkeypatch):
    """the loss over the first half of each batch's rows only"""
    from osu_dreamer_tpu_torch.models.diffusion import train

    loss = train.diffusion_loss

    def half(model, batch, args, generator=None, t=None, x0=None, **kw):
        n = batch.z.shape[0] // 2
        return loss(model, train.LatentBatch(*(f[:n] for f in batch)), args, generator,
                    t[:n], x0[:n], **kw)

    monkeypatch.setattr(train, "diffusion_loss", half)


def _answer_predict(monkeypatch):
    """one row's hit channels inverted where the chart is quantized"""
    from osu_dreamer_tpu_torch.models.inference import sampler

    quantize = sampler.quantize_chart

    def altered(chart):
        hit, xy = quantize(chart)
        hit = hit.clone()
        hit[0] = 255 - hit[0]
        return hit, xy

    monkeypatch.setattr(sampler, "quantize_chart", altered)


def _sampler(monkeypatch, fn):
    from osu_dreamer_tpu_torch.models.diffusion.model import DiffusionModel

    sample = DiffusionModel.sample
    monkeypatch.setattr(DiffusionModel, "sample",
                        lambda self, audio, style, num_steps, x0=None, **kw:
                        fn(sample, self, audio, style, num_steps, x0, **kw))


def _unchanged_predict(monkeypatch):
    """the denoiser's steps leave the sampler's state as it started"""
    _sampler(monkeypatch, lambda sample, self, audio, style, n, x0, **kw: x0.float())


def _half_batch_predict(monkeypatch):
    """the denoiser samples the first half of the rows, its step size from
    their mean alone; the other half copies them"""
    def half(sample, self, audio, style, n, x0, **kw):
        k = x0.shape[0] // 2
        x = sample(self, audio[:k], style[:k], n, x0=x0[:k], **kw)
        return torch.cat([x, x[: x0.shape[0] - k]])

    _sampler(monkeypatch, half)


FAULTS = {"predict_batch": [_answer_predict, _unchanged_predict, _half_batch_predict],
          "denoiser_step": [_unchanged_train, _half_batch_train]}


CASES = [(name, fault) for name in CELLS
         for fault in FAULTS[resolve(benchmark(ROOT), name).wl["driver"]]]


def _run(cell):
    return run_cell(cell, 2**31 + 21, 0.1, False, "cpu", time.perf_counter())


_SOUND: dict = {}


def _sound(name: str) -> dict:
    """the same tiny run without a fault (the CPU's plain bf16 path, so its
    numbers need not meet the card's limits)"""
    if name not in _SOUND:
        _SOUND[name] = _run(tiny(resolve(benchmark(ROOT), name)))["checks"]
    return _SOUND[name]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_fault_reads_incorrect(monkeypatch, name, fault):
    """the fault fails the run, and by a number that the sound run meets"""
    sound = _sound(name)
    fault(monkeypatch)
    result = _run(tiny(resolve(benchmark(ROOT), name)))
    assert not result["correct"], (fault.__name__, result["checks"])
    flipped = [k for k, c in result["checks"].items()
               if c["value"] > c["limit"] >= sound[k]["value"]]
    assert flipped, (fault.__name__, result["checks"], sound)
