"""Resonator-bank spectrogram featurizer.

Counterpart of osu_dreamer_tpu/audio/spectrogram.py: a bank of 72 complex
one-pole resonators, y[n] = alpha x[n] + (1 - alpha) e^{i omega} y[n-1],
evaluated at frame boundaries (ops/resonator.py), then log power normalised
so the loudest real frame of each song maps to 1 and 60 dB below it to 0.

``resonator_alphas`` and ``prep_wave_for_model`` are numpy, copied from the
JAX module (tests pin them to it); ``spec_for_model_batch`` is the device part
and never leaves the device. ``make_spec`` is the dataset build's host entry:
one float wave in, its (F, frames) spectrogram out, normalised over every
frame of its padded bucket as the JAX ``make_spec`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resonator import resonate_frames
from ..utils.device import resolve_device
from .constants import HOP_LEN, SR, resonator_freqs

# constant-Q quality factor: each bin's bandwidth spans one bin spacing
Q_FACTOR = 1.0 / (2.0 ** (1.0 / 18.0) - 2.0 ** (-1.0 / 18.0))
# chunk granularity for padding wave lengths: songs of one ~6 s size class
# share every downstream shape
WAVE_BUCKET = HOP_LEN * 1024


def resonator_alphas(freqs: np.ndarray) -> np.ndarray:
    """per-frequency smoothing: one-pole bandwidth tracks the constant-Q bin
    bandwidth, so each bin integrates ~Q cycles"""
    return 1.0 - np.exp(-2.0 * np.pi * freqs / (Q_FACTOR * SR))


def resonator_poles() -> tuple[np.ndarray, np.ndarray]:
    """-> (alpha (F,) float64, b (F,) complex128): y[n] = alpha x[n] + b y[n-1]"""
    freqs = resonator_freqs().astype(np.float64)
    alpha = resonator_alphas(freqs)
    return alpha, (1.0 - alpha) * np.exp(1j * 2.0 * np.pi * freqs / SR)


def prep_wave_for_model(wave: np.ndarray, chunk: int) -> tuple[np.ndarray, int, int, int]:
    """host-side prep: -> (int16 bucket-padded wave, real_frames, n_frames,
    out_frames); scales down only if the wave would clip"""
    n = len(wave)
    real_frames = max(1, int(np.ceil(n / HOP_LEN)))
    padded_len = int(np.ceil(max(n, 1) / WAVE_BUCKET)) * WAVE_BUCKET
    peak = float(np.abs(wave).max()) if n else 0.0
    scale = 32767.0 / max(peak, 1.0)
    buf = np.zeros(padded_len, dtype=np.int16)
    buf[:n] = np.round(wave * min(scale, 32767.0)).astype(np.int16)
    n_frames = padded_len // HOP_LEN
    out_frames = -(-n_frames // chunk) * chunk
    return buf, real_frames, n_frames, out_frames


def make_spec(wave: np.ndarray, device: torch.device | str = "cuda") -> np.ndarray:
    """(N,) float wave at SR -> (F, ceil(N / HOP_LEN)) f32 in [0, 1] on the
    host, computed on ``device`` (a CUDA card unless ``cpu`` is asked for):
    the wave zero-padded to a multiple of WAVE_BUCKET, its resonator states
    (the kernel on the card), log power normalised so the loudest frame of
    the padded bucket maps to 1 and 60 dB below it to 0, then cropped"""
    device = resolve_device(device, "featurize")
    n = len(wave)
    n_frames = max(1, int(np.ceil(n / HOP_LEN)))
    padded_len = int(np.ceil(max(n, 1) / WAVE_BUCKET)) * WAVE_BUCKET
    buf = np.zeros(padded_len, dtype=np.float32)
    buf[:n] = wave
    frames = torch.from_numpy(buf).to(device).reshape(1, padded_len // HOP_LEN, HOP_LEN)
    states = resonate_frames(frames)[0]  # (K, F, 2)
    power = (states[..., 0].square() + states[..., 1].square()).clamp_min(1e-10)
    sig = torch.log10(power) - torch.log10(power.max())
    sig = ((15.0 * sig + 60.0) / 60.0).clamp(0.0, 1.0)
    return sig[:n_frames].T.cpu().numpy()


def spec_for_model_batch(
    waves_i16: torch.Tensor,    # (S, len) int16
    real_frames: torch.Tensor,  # (S,) integer frame counts
    n_frames: int,
    out_frames: int,
) -> torch.Tensor:
    """-> (S, out_frames, F) in [0, 1]: per-song top-60 dB normalisation over
    the real frames only, edge-replicated to ``out_frames``"""
    S = waves_i16.shape[0]
    wave = waves_i16.float() / 32767.0
    frames = wave[:, : n_frames * HOP_LEN].reshape(S, n_frames, HOP_LEN)
    states = resonate_frames(frames)  # (S, K, F, 2)
    power = states[..., 0].square() + states[..., 1].square()  # (S, K, F)

    pos = torch.arange(n_frames, device=wave.device)
    valid = (pos[None, :] < real_frames[:, None])[..., None]  # (S, K, 1)
    sig = torch.log10(power.clamp_min(1e-10))
    peak = sig.masked_fill(~valid, float("-inf")).amax(dim=(1, 2), keepdim=True)
    sig = ((15.0 * (sig - peak) + 60.0) / 60.0).clamp(0.0, 1.0)

    idx = torch.minimum(
        torch.arange(out_frames, device=wave.device)[None, :], real_frames[:, None] - 1
    )  # (S, out_frames)
    return torch.gather(sig, 1, idx[..., None].expand(-1, -1, sig.shape[-1]))
