"""The batched featurize + sample device program of predict and serve.

Counterpart of osu_dreamer_tpu/models/inference/sampler.py on one device (no
mesh): int16 waves -> resonator spectrogram -> LDM -> the quantized chart
transfer format, all on the device; only the quantized chart and labels are
meant to leave it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...audio.spectrogram import spec_for_model_batch
from ...signal.constants import HIT_DIM
from .model import LDM

# quantized chart transfer: hit channels as uint8 on the round(x*255) grid,
# cursor x/y as int16 fixed point on [-4, 4] (11 bytes per frame, not 36)
XY_QRANGE = 4.0
XY_QSCALE = 8191.0


def quantize_chart(chart: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., L, 9) chart in its compute dtype -> ((..., L, 7) uint8,
    (..., L, 2) int16), computed in that dtype as the JAX sampler does. The
    int16 conversion saturates as XLA's does: in bf16, 4 * 8191 rounds up to
    32768."""
    hit = torch.round(chart[..., :HIT_DIM].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    xy = torch.round(chart[..., HIT_DIM:].clamp(-XY_QRANGE, XY_QRANGE) * XY_QSCALE)
    return hit, xy.to(torch.int32).clamp(-32768, 32767).to(torch.int16)


def dequantize_chart(hit_u8, xy_i16) -> np.ndarray:
    """(..., L, 7) uint8 + (..., L, 2) int16 -> (..., L, 9) float32 chart"""
    hit = np.asarray(hit_u8).astype(np.float32) / 255.0
    xy = np.asarray(xy_i16).astype(np.float32) / XY_QSCALE
    return np.concatenate([hit, xy], axis=-1)


def build_batch_sampler(model: LDM) -> Callable:
    """-> ``sample(waves_i16, real_frames, labels, generator, n_frames,
    out_frames, steps, guidance, s0=None, x0=None)`` returning device
    tensors ``(hit_u8, xy_i16, labels)``.

    waves_i16 (S, len) int16, real_frames (S,) integer and labels (D, 5) or
    (S, D, 5) f32 all live on the model's device; ``n_frames`` and
    ``out_frames`` come from ``prep_wave_for_model``. ``s0``/``x0`` inject the
    samplers' starting noise (see ``LDM.forward``)."""

    @torch.inference_mode()
    def sample(waves_i16, real_frames, labels, generator, n_frames, out_frames, steps,
               guidance, s0=None, x0=None):
        spec = spec_for_model_batch(waves_i16, real_frames, n_frames, out_frames)
        chart, out_labels = model(
            spec, labels, steps, style_guidance=guidance, s0=s0, x0=x0, generator=generator
        )
        hit, xy = quantize_chart(chart)
        return hit, xy, out_labels

    return sample
