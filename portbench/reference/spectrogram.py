"""The resonator-bank spectrogram, from its definition, in float64.

72 complex one-pole resonators, log-spaced from 32 Hz by 9 a octave, each
y[n] = alpha x[n] + (1 - alpha) e^{i omega} y[n-1] with a constant-Q
bandwidth, read at the end of every 98-sample frame. The log power of each
song is normalised so that its loudest real frame maps to 1 and 60 dB below
it to 0, and the frames are edge-replicated to the model's length.
``prep_wave`` is the host's rule for a wave entering the model: scaled
down only if it would clip, rounded to int16, zero-padded to whole buckets
of 1024 frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 16384
HOP = 98
N_BINS = 72
WAVE_BUCKET = HOP * 1024


def prep_wave(wave: np.ndarray, chunk: int) -> tuple[np.ndarray, int, int, int]:
    """float wave -> (int16 padded wave, real frames, frames, frames rounded up to ``chunk``)"""
    n = len(wave)
    real_frames = max(1, math.ceil(n / HOP))
    padded = math.ceil(max(n, 1) / WAVE_BUCKET) * WAVE_BUCKET
    peak = float(np.abs(wave).max()) if n else 0.0
    scale = min(32767.0 / max(peak, 1.0), 32767.0)
    buf = np.zeros(padded, dtype=np.int16)
    buf[:n] = np.round(wave * scale).astype(np.int16)
    n_frames = padded // HOP
    return buf, real_frames, n_frames, -(-n_frames // chunk) * chunk


def poles() -> tuple[np.ndarray, np.ndarray]:
    freqs = np.geomspace(32, 8192, N_BINS, endpoint=False).astype(np.float32).astype(np.float64)
    q = 1.0 / (2.0 ** (1.0 / 18.0) - 2.0 ** (-1.0 / 18.0))
    alpha = 1.0 - np.exp(-2.0 * np.pi * freqs / (q * SR))
    return alpha, (1.0 - alpha) * np.exp(2j * np.pi * freqs / SR)


def frame_states(wave: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(S, samples) float64 -> (S, K, F) complex128 states at frame ends:
    y_k = b^HOP y_{k-1} + sum_j alpha b^(HOP-1-j) x[k HOP + j], the
    recurrence over frames by doubling"""
    alpha, b = poles()
    dev = wave.device
    j = np.arange(HOP)
    w = torch.from_numpy(alpha[None, :] * b[None, :] ** (HOP - 1 - j)[:, None]).to(dev)
    S = wave.shape[0]
    frames = wave[:, :n_frames * HOP].reshape(S, n_frames, HOP).to(torch.complex128)
    y = frames @ w
    a = torch.from_numpy(b ** HOP).to(dev)
    d = 1
    while d < n_frames:
        y = torch.cat([y[:, :d], y[:, d:] + a * y[:, :-d]], dim=1)
        a = a * a
        d *= 2
    return y


def spec_for_model(waves_i16: torch.Tensor, real_frames: torch.Tensor, n_frames: int,
                   out_frames: int) -> torch.Tensor:
    """(S, samples) int16 -> (S, out_frames, 72) float32 in [0, 1]"""
    y = frame_states(waves_i16.double() / 32767.0, n_frames)
    sig = torch.log10((y.real.square() + y.imag.square()).clamp_min(1e-10))
    valid = torch.arange(n_frames, device=y.device)[None, :, None] < real_frames[:, None, None]
    peak = sig.masked_fill(~valid, float("-inf")).amax(dim=(1, 2), keepdim=True)
    sig = ((15.0 * (sig - peak) + 60.0) / 60.0).clamp(0.0, 1.0)
    idx = torch.minimum(torch.arange(out_frames, device=y.device)[None], real_frames[:, None] - 1)
    return torch.gather(sig, 1, idx[..., None].expand(-1, -1, N_BINS)).float()
