"""Faults of a training step (``drivers/denoiser_step.py``), each planted in
the program with pytest's ``monkeypatch``."""

from __future__ import annotations

import torch


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


FAULTS = [_unchanged_train, _half_batch_train]
