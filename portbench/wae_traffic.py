"""The chart WAE's training traffic: what ``fit-latent``'s data pipeline would
feed its step, made on the device from the seed and the workload file's
parameters, in a few large calls.

- ``windows``: ``wl["pool"]`` batches of ``wl["batch"]`` windows of
  ``wl["seq_len"]`` frames: audio features (72 bins in [0, 1] on the grid
  of the uint8 spectrogram the corpus stores), a chart of 7 soft hit
  channels (pulses at ``hit_rate`` a frame, each decaying over
  ``hit_decay_frames``, at most 1) and a cursor (a random walk of
  ``cursor_step`` in the unit square), and 5 labels in [0, 10];
- ``draws``: the loss's seven random draws for one step, in the order the
  step draws them: the MMD's prior sample, the style and latent noise, the
  style mask's uniform and its replacement, the latent mask's span and
  start uniforms.

The streams are ``traffic.py``'s (``generator``), so a batch or a step's
draws can be made again after the window.
"""

from __future__ import annotations

import torch

from .traffic import generator

A_DIM, HIT_DIM, NUM_LABELS = 72, 7, 5


def windows(wl: dict, seed: int, device) -> list[tuple]:
    """-> [(audio (B, L, 72), chart (B, L, 9), labels (B, 5))] f32 on ``device``"""
    B, L, n, c = wl["batch"], wl["seq_len"], wl["pool"], wl["chart"]
    g = generator(device, seed, "latents")
    levels = c["spec_levels"]
    audio = torch.randint(0, levels + 1, (n, B, L, A_DIM), generator=g, device=device) / levels
    pulses = (torch.rand(n, B, L, HIT_DIM, generator=g, device=device) < c["hit_rate"]).float()
    taps = torch.exp(-torch.arange(8, device=device, dtype=torch.float32) / c["hit_decay_frames"])
    padded = torch.nn.functional.pad(pulses, (0, 0, len(taps) - 1, 0))
    hits = sum(padded[:, :, len(taps) - 1 - i:len(taps) - 1 - i + L] * taps[i]
               for i in range(len(taps))).clamp(max=1.0)
    steps = c["cursor_step"] * torch.randn(n, B, L, 2, generator=g, device=device)
    cursor = (0.5 + steps.cumsum(dim=2)).clamp(0.0, 1.0)
    labels = 10.0 * torch.rand(n, B, NUM_LABELS, generator=g, device=device)
    chart = torch.cat([hits, cursor], dim=-1)
    return [(audio[i].float(), chart[i], labels[i]) for i in range(n)]


def draws(cfg: dict, wl: dict, seed: int, index: int, device) -> tuple[torch.Tensor, ...]:
    """step ``index``'s seven draws for the 2B window halves: (prior (2B, S),
    s_noise (2B, S), z_noise (2B, l, E), s_mask (2B,), s_repl (2B, S),
    span (2B,), start (2B,)), f32 on ``device``"""
    a = cfg["latent"]
    n, S, E = 2 * wl["batch"], a["style_dim"], a["emb_dim"]
    l = wl["seq_len"] // 2 // a["stride"] ** a["n_downs"]
    g = generator(device, seed, "noise", index)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    return (normal(n, S), normal(n, S), normal(n, l, E), uniform(n), normal(n, S), uniform(n),
            uniform(n))
