"""Faults of a predict batch (``drivers/predict_batch.py``), each planted in
the program with pytest's ``monkeypatch``."""

from __future__ import annotations

import torch


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


FAULTS = [_answer_predict, _unchanged_predict, _half_batch_predict]
