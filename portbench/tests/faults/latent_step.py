"""Faults of a chart WAE training step (``drivers/latent_step.py``), each
planted in the program with pytest's ``monkeypatch``."""

from __future__ import annotations

import torch


def _unchanged_latent(monkeypatch):
    """a step that returns the weights unchanged: no update"""
    from osu_dreamer_tpu_torch.train import state

    monkeypatch.setattr(state.AdamW, "step", lambda self, grads, norm=None: torch.zeros(()))


def _half_batch_latent(monkeypatch):
    """the loss over the first half of each batch's windows only (and their
    halves' draws, the MMD's prior sample cut to as many)"""
    from osu_dreamer_tpu_torch.models.latent import train

    loss = train.latent_loss

    def half(model, batch, args, generator=None, is_train=True, draws=None, par=None):
        n = batch.chart.shape[0] // 2
        draws = train.LatentDraws(*(d[:2 * n] for d in draws))
        return loss(model, train.Batch(*(f[:n] for f in batch)), args, generator, is_train,
                    draws, par)

    monkeypatch.setattr(train, "latent_loss", half)


FAULTS = [_unchanged_latent, _half_batch_latent]
