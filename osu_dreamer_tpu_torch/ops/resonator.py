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

# the kernel's scan decomposition (csrc/resonator.cu): chunks of SEGS
# segments of SEG_ROWS frames, a thread's bins BIN_GROUPS apart, group
# aggregates over GROUP chunks
SEG_ROWS = 4
SEGS = 32
CHUNK = SEGS * SEG_ROWS
BIN_GROUPS = 8
GROUP = 16
N_LEVELS = 24     # doubling levels of the plain scan: songs up to 2^24 frames


@cache
def _host_tables() -> dict[str, np.ndarray]:
    """f64-derived f32 tables: W (HOP, 2F) contribution weights [re | im];
    levels (N_LEVELS, F) complex A^(2^k) (the plain scan); the kernel's
    powers pw (rows, F, 2) [re, im]: A^k for k <= CHUNK, A^(CHUNK p) for
    p < GROUP, A^(CHUNK GROUP)"""
    from ..audio.spectrogram import resonator_poles

    alpha, b = resonator_poles()
    j = np.arange(HOP_LEN)
    w = alpha[None, :] * b[None, :] ** (HOP_LEN - 1 - j)[:, None]  # (HOP, F)
    bH = b**HOP_LEN
    exps = np.concatenate([np.arange(CHUNK + 1), CHUNK * np.arange(GROUP), [CHUNK * GROUP]])
    powers = bH[None, :] ** exps[:, None]
    return {
        "W": np.concatenate([w.real, w.imag], axis=1).astype(np.float32),
        "levels": np.stack([bH ** (1 << k) for k in range(N_LEVELS)]).astype(np.complex64),
        "pw": np.stack([powers.real, powers.imag], axis=-1).astype(np.float32),
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
    """the csrc/resonator.cu kernel: one pass over the frames (after a
    memset of its status words: a ticket, chunk and group flags, group
    counts), carries combined in a fixed order"""
    check_cuda("frames", frames, torch.float32, 3)
    S, K, hop = frames.shape
    if hop != HOP_LEN or K < 1:
        raise ValueError(f"frames must be (S, K >= 1, {HOP_LEN}), got {tuple(frames.shape)}")
    t = _device_tables(frames.device)
    n_chunks = -(-K // CHUNK)
    n_groups = n_chunks // GROUP
    out = torch.empty(S, K, N_BINS, 2, dtype=torch.float32, device=frames.device)
    agg = torch.empty(S, n_chunks, N_BINS, 2, dtype=torch.float32, device=frames.device)
    gagg = torch.empty(S, max(n_groups, 1), N_BINS, 2, dtype=torch.float32, device=frames.device)
    status = torch.empty(1 + S * (n_chunks + 2 * n_groups), dtype=torch.int32,
                         device=frames.device)
    run(
        "odt_resonate", "resonator", frames.device,
        frames.data_ptr(), t["W"].data_ptr(), t["pw"].data_ptr(), out.data_ptr(),
        agg.data_ptr(), gagg.data_ptr(), status.data_ptr(), S, K,
    )
    return out


def resonate_frames(frames: torch.Tensor) -> torch.Tensor:
    """resonator states: kernel for CUDA tensors, plain version for CPU tensors"""
    if frames.is_cuda:
        return resonate_cuda(frames)
    if frames.device.type != "cpu":
        raise ValueError(f"resonate_frames: no implementation for device {frames.device}")
    return resonate_plain(frames)
