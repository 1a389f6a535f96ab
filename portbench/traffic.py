"""The one traffic generator: everything a cell feeds the program, made from
the seed and the parameters of its workload file, on the device, in a few
large calls.

- ``songs``: synthetic music at the model's sample rate: a beat of decaying
  percussive noise bursts at a tempo drawn per song, and a melody of
  decaying partials on the beat grid, with a little background noise;
  prepared for the model by the host's rule (reference/spectrogram.py
  ``prep_wave``), as int16 waves.
- ``labels``: one mapset a song, difficulty rows from Easy to Expert: each
  label runs linearly over its range across the rows, plus uniform jitter.
- ``latent_batches``: cached latent-space training batches: audio features,
  chart latents and style codes, each RMS-normalised as the encoder leaves
  them; the latents smoothed over a few frames.
- ``noise``: the injected noise of a sampler batch (s0, x0) or of a train
  step (t stratified logit-normal, x0).

Every stream draws from its own generator, seeded by ``seed_of(seed,
stream, index)``, so a batch can be drawn again after the window.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.spectrogram import SR, prep_wave

_STREAMS = {"weights": 0, "songs": 1, "labels": 2, "latents": 3, "noise": 4, "pick": 5, "state": 6}


def seed_of(seed: int, stream: str, index: int = 0) -> int:
    """a 63-bit seed for one stream and index, from the run's seed"""
    state = np.random.SeedSequence([seed % 2**64, _STREAMS[stream], index]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) % 2**63)


def generator(device, seed: int, stream: str, index: int = 0) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed_of(seed, stream, index))


def songs(wl: dict, seed: int, index: int, chunk: int, device) -> dict:
    """one batch of ``wl["songs"]`` songs of ``wl["song_seconds"]`` ->
    {"waves" (S, samples) int16, "real_frames" (S,) int64, "n_frames",
    "out_frames"} on ``device``"""
    a = wl["audio"]
    S, n = wl["songs"], int(round(wl["song_seconds"] * SR))
    g = generator(device, seed, "songs", index)
    u = torch.rand(S, 4, generator=g, device=device)
    bpm = a["bpm"][0] + (a["bpm"][1] - a["bpm"][0]) * u[:, 0]
    beat = (60.0 / bpm * SR)[:, None]                                    # samples a beat
    t = torch.arange(n, device=device, dtype=torch.float32)[None]
    phase = torch.remainder(t + u[:, 1:2] * beat, beat)                  # samples since the beat
    hits = torch.randn(S, n, generator=g, device=device) * torch.exp(-phase / (0.02 * SR))
    notes = int(math.ceil(n / float(beat.min()))) + 1
    pitch = torch.randint(0, a["pitches"], (S, notes), generator=g, device=device)
    f0 = a["f0_hz"] * 2.0 ** (pitch.float() / 12.0)
    k = torch.clamp(((t + u[:, 1:2] * beat) // beat).long(), max=notes - 1)
    f = torch.gather(f0, 1, k)
    tone = sum(torch.sin(2 * math.pi * f * (p + 1) * t / SR) / (p + 1) for p in range(a["partials"]))
    wave = (a["beat_level"] * hits + a["tone_level"] * tone * torch.exp(-phase / (0.25 * SR))
            + a["noise_level"] * torch.randn(S, n, generator=g, device=device))
    wave = wave * (a["peak"] / wave.abs().amax(dim=1, keepdim=True))
    preps = [prep_wave(w, chunk) for w in wave.cpu().numpy()]
    return {"waves": torch.from_numpy(np.stack([p[0] for p in preps])).to(device),
            "real_frames": torch.tensor([p[1] for p in preps], device=device),
            "n_frames": preps[0][2], "out_frames": preps[0][3]}


def labels(wl: dict, seed: int, index: int, device) -> torch.Tensor:
    """(S, D, 5) sr, ar, od, cs, hp: row d of D runs each label from the low
    to the high end of its range, plus U(-jitter, jitter), clipped to the range"""
    S, D = wl["songs"], wl["difficulties"]
    ranges = torch.tensor([wl["labels"][k] for k in ("sr", "ar", "od", "cs", "hp")],
                          device=device)                                   # (5, 2)
    frac = torch.linspace(0.0, 1.0, D, device=device)[:, None]
    base = ranges[:, 0] + frac * (ranges[:, 1] - ranges[:, 0])             # (D, 5)
    g = generator(device, seed, "labels", index)
    jitter = (2 * torch.rand(S, D, 5, generator=g, device=device) - 1) * wl["labels"]["jitter"]
    return torch.minimum(torch.maximum(base + jitter, ranges[:, 0]), ranges[:, 1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)


def latent_batches(cfg: dict, wl: dict, seed: int, device) -> list[tuple]:
    """``wl["pool"]`` batches (h (B, l, a_dim), z (B, l, emb_dim), s (B,
    style_dim), labels (B, 5)), f32 on ``device``"""
    d = cfg["diffusion"]
    B, l, n = wl["batch"], wl["seq_len"], wl["pool"]
    g = generator(device, seed, "latents")
    h = _rms(torch.randn(n, B, l, d["a_dim"], generator=g, device=device))
    z = torch.randn(n, B, l + 4, d["emb_dim"], generator=g, device=device)
    z = _rms(sum(z[:, :, i:i + l] for i in range(5)))
    s = _rms(torch.randn(n, B, d["style_dim"], generator=g, device=device))
    lab = 10.0 * torch.rand(n, B, 5, generator=g, device=device)
    return [(h[i], z[i], s[i], lab[i]) for i in range(n)]


def sampler_noise(cfg: dict, rows: int, l: int, seed: int, index: int, device):
    """(s0 (rows, style_dim), x0 (rows, l, emb_dim)) of sampler batch ``index``"""
    g = generator(device, seed, "noise", index)
    s0 = torch.randn(rows, cfg["style"]["style_dim"], generator=g, device=device)
    return s0, torch.randn(rows, l, cfg["diffusion"]["emb_dim"], generator=g, device=device)


def train_noise(cfg: dict, B: int, l: int, seed: int, index: int, device):
    """(t (B,), x0 (B, l, emb_dim)) of train step ``index``: t stratified
    logit-normal (a permuted stratum plus jitter, through the normal
    quantile and a sigmoid)"""
    g = generator(device, seed, "noise", index)
    strata = torch.randperm(B, generator=g, device=device).float()
    u = (strata + torch.rand(B, generator=g, device=device)) / B
    t = torch.sigmoid(torch.special.ndtri(u.clamp(1e-6, 1.0 - 1e-6)))
    return t, torch.randn(B, l, cfg["diffusion"]["emb_dim"], generator=g, device=device)
