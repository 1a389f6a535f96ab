"""Resonator-bank recurrence: the plain PyTorch version and the CUDA kernel.

Counterpart of osu_dreamer_tpu/ops/resonator.py (``resonate_frames_pallas``)
and of the associative-scan path in osu_dreamer_tpu/audio/spectrogram.py.
Per bin f, the complex state at the end of frame k is

    y_k = A_f * y_{k-1} + frames[k] @ W[:, f]      (A_f = b_f^HOP)

``resonate_frames`` maps (S, K, HOP) f32 frames of S songs to (S, K, F, 2)
[re, im] states; each song starts from a zero state. It dispatches by device:
a CUDA tensor goes to the kernel in ``csrc/resonator.cu``, a CPU tensor to
``resonate_plain``.
"""

from __future__ import annotations

from functools import cache

import numpy as np
import torch

from ..audio.constants import HOP_LEN, N_BINS
from ._build import check_cuda, run

CHUNK = 64        # frames per in-chunk scan (csrc/resonator.cu kChunk)
N_LEVELS = 24     # doubling levels of the plain scan: songs up to 2^24 frames


@cache
def _host_tables() -> dict[str, np.ndarray]:
    """f64-derived f32 tables: W (HOP, 2F) contribution weights [re | im];
    levels (N_LEVELS, F) complex A^(2^k); A, AT = A^CHUNK (F, 2) and
    P (CHUNK, F, 2) = A^(i+1), as [re, im] pairs"""
    from ..audio.spectrogram import resonator_poles

    alpha, b = resonator_poles()
    j = np.arange(HOP_LEN)
    w = alpha[None, :] * b[None, :] ** (HOP_LEN - 1 - j)[:, None]  # (HOP, F)
    bH = b**HOP_LEN

    def pairs(z: np.ndarray) -> np.ndarray:
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)

    return {
        "W": np.concatenate([w.real, w.imag], axis=1).astype(np.float32),
        "levels": np.stack([bH ** (1 << k) for k in range(N_LEVELS)]).astype(np.complex64),
        "A": pairs(bH),
        "AT": pairs(bH**CHUNK),
        "P": pairs(bH[None, :] ** (np.arange(CHUNK) + 1)[:, None]),
    }


@cache
def _device_tables(device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in _host_tables().items()}


def resonate_plain(frames: torch.Tensor) -> torch.Tensor:
    """contribution matmul, then a Hillis-Steele doubling scan over the whole
    song: (S, K, HOP) f32 -> (S, K, F, 2)"""
    t = _device_tables(frames.device)
    c = frames @ t["W"]  # (S, K, 2F)
    y = torch.complex(c[..., :N_BINS], c[..., N_BINS:])
    K = y.shape[1]
    for k in range(N_LEVELS):
        d = 1 << k
        if d >= K:
            break
        y = torch.cat([y[:, :d], y[:, d:] + t["levels"][k] * y[:, :-d]], dim=1)
    return torch.view_as_real(y)


def resonate_cuda(frames: torch.Tensor) -> torch.Tensor:
    """the csrc/resonator.cu kernel (three launches: chunk product + scan,
    cross-chunk carry, carry application)"""
    check_cuda("frames", frames, torch.float32, 3)
    S, K, hop = frames.shape
    if hop != HOP_LEN:
        raise ValueError(f"frames must be (S, K, {HOP_LEN}), got {tuple(frames.shape)}")
    t = _device_tables(frames.device)
    n_chunks = -(-K // CHUNK)
    out = torch.empty(S, K, N_BINS, 2, dtype=torch.float32, device=frames.device)
    last = torch.empty(S, n_chunks, N_BINS, 2, dtype=torch.float32, device=frames.device)
    carry = torch.empty_like(last)
    run(
        "odt_resonate", "resonator", frames.device,
        frames.data_ptr(), t["W"].data_ptr(), t["A"].data_ptr(), t["AT"].data_ptr(),
        t["P"].data_ptr(), out.data_ptr(), last.data_ptr(), carry.data_ptr(), S, K,
    )
    return out


def resonate_frames(frames: torch.Tensor) -> torch.Tensor:
    """resonator states: kernel for CUDA tensors, plain version for CPU tensors"""
    if frames.is_cuda:
        return resonate_cuda(frames)
    if frames.device.type != "cpu":
        raise ValueError(f"resonate_frames: no implementation for device {frames.device}")
    return resonate_plain(frames)
