"""The batched featurize + sample device program of predict and serve.

Counterpart of osu_dreamer_tpu/models/inference/sampler.py: int16 waves ->
resonator spectrogram -> LDM -> the quantized chart transfer format, all on
the device; only the quantized chart and labels are meant to leave it.
``build_batch_sampler`` runs a batch on one device; ``build_sharded_sampler``
splits its songs over model replicas (parallel/replicas.py), the JAX
sampler's ``shard_map`` over a ``data`` mesh.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ...audio.spectrogram import spec_for_model_batch
from ...parallel.replicas import song_shards
from ...signal.constants import HIT_DIM
from ...train.profiling import span
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


# the spans a batch records inside its ``sample`` span, in the order they run
STAGES = ("featurize", "latent.encode", "style.sample", "diffusion.sample", "latent.decode")


def build_batch_sampler(model: LDM) -> Callable:
    """-> ``sample(waves_i16, real_frames, labels, generator, n_frames,
    out_frames, steps, guidance, s0=None, x0=None)`` returning device
    tensors ``(hit_u8, xy_i16, labels)``.

    waves_i16 (S, len) int16, real_frames (S,) integer and labels (D, 5) or
    (S, D, 5) f32 all live on the model's device; ``n_frames`` and
    ``out_frames`` come from ``prep_wave_for_model``. ``s0``/``x0`` inject the
    samplers' starting noise (see ``LDM.forward``). A call is one ``sample``
    span (train/profiling.py) around the ``STAGES`` spans."""

    @torch.inference_mode()
    @span("sample")
    def sample(waves_i16, real_frames, labels, generator, n_frames, out_frames, steps,
               guidance, s0=None, x0=None, batch_mean=None):
        with span("featurize"):
            spec = spec_for_model_batch(waves_i16, real_frames, n_frames, out_frames)
        chart, out_labels = model(
            spec, labels, steps, style_guidance=guidance, s0=s0, x0=x0, generator=generator,
            batch_mean=batch_mean,
        )
        hit, xy = quantize_chart(chart)
        return hit, xy, out_labels

    return sample


class Shard(NamedTuple):
    """one replica's part of a sharded batch: its songs and rows, its
    quantized chart and labels (pinned host tensors on the card, which the
    copies land in until ``ready`` has happened; CPU tensors off it)"""

    songs: slice
    rows: slice
    hit_u8: torch.Tensor
    xy_i16: torch.Tensor
    labels: torch.Tensor
    ready: torch.cuda.Event | None


class _BatchMean:
    """the mean over a whole batch of per-row values split over the shards:
    each shard's sum and count meet on the host (the one wait of a sampler
    on its device, after its first prediction), and every shard takes the
    same mean. A shard that fails aborts the barrier, so the others raise
    instead of waiting"""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.parts = [(0.0, 0)] * n

    def for_shard(self, k: int) -> Callable:
        def mean(u: torch.Tensor) -> torch.Tensor:
            self.parts[k] = (float(u.double().sum()), u.numel())
            self.barrier.wait()
            total = sum(p[0] for p in self.parts) / sum(p[1] for p in self.parts)
            self.barrier.wait()  # every shard has read the parts before the next exchange
            return torch.tensor(total, dtype=u.dtype, device=u.device)

        return mean


def build_sharded_sampler(replicas: Sequence[LDM]) -> Callable:
    """-> ``sample(waves_i16, real_frames, labels, seed, n_frames, out_frames,
    steps, guidance)`` returning one ``Shard`` a replica used, in song order.

    Inputs are host tensors: waves_i16 (S, len) int16, real_frames (S,)
    integer, labels (D, 5) or (S, D, 5) f32. The starting noise is drawn at
    the batch's whole shape from ``torch.Generator`` seeded with ``seed`` on
    the first replica's device, in the one-device sampler's order (the style
    prior's s0, then the denoiser's x0), and split by song rows; the songs
    are split over the replicas as ``song_shards`` says. Each shard runs on
    its own host thread with its device current and its own stream: its
    waves and labels go up from pinned memory, it samples, and its results
    come back to pinned host buffers behind one CUDA event. The samplers'
    step-size calibration takes the mean over the whole batch. So a seeded
    shard gives the one-device sampler's chart for the same rows a launch
    (bit for bit on the card). Against one launch of the whole batch it
    differs as the one-device path itself does between batch sizes: on the
    card kernel plans and library products change with the rows a launch
    holds (on the CPU the charts agree)."""
    replicas = list(replicas)
    devices = [next(m.parameters()).device for m in replicas]
    samplers = [build_batch_sampler(m) for m in replicas]
    cuda = devices[0].type == "cuda"
    streams = [torch.cuda.Stream(device=d) for d in devices] if cuda else [None] * len(devices)
    pool = ThreadPoolExecutor(max_workers=len(replicas), thread_name_prefix="odt-replica")
    args0 = replicas[0].args

    def shard(k, songs, rows, waves, real, labels, s0, x0, drawn, mean, n_frames, out_frames,
              steps, guidance) -> Shard:
        try:
            return run_shard(k, songs, rows, waves, real, labels, s0, x0, drawn,
                             mean.for_shard(k), n_frames, out_frames, steps, guidance)
        except BaseException:
            mean.barrier.abort()  # the other shards raise instead of waiting for this one
            raise

    def run_shard(k, songs, rows, waves, real, labels, s0, x0, drawn, mean, n_frames,
                  out_frames, steps, guidance) -> Shard:
        dev, stream = devices[k], streams[k]
        with torch.cuda.device(dev) if cuda else nullcontext(), \
                torch.cuda.stream(stream) if cuda else nullcontext(), torch.inference_mode():
            if cuda:
                stream.wait_event(drawn)
                if dev == devices[0]:  # read on this stream, freed on the drawing one
                    s0.record_stream(stream)
                    x0.record_stream(stream)

            def up(t):
                if cuda and not t.is_cuda:
                    t = t.pin_memory()
                return torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t, non_blocking=True)

            lab = labels[songs] if labels.dim() == 3 else labels
            out = samplers[k](up(waves[songs]), up(real[songs]), up(lab), None, n_frames,
                              out_frames, steps, guidance, s0=up(s0[rows]), x0=up(x0[rows]),
                              batch_mean=mean)
            ready = None
            if cuda:
                out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                            .copy_(t, non_blocking=True) for t in out)
                ready = torch.cuda.Event()
                ready.record(stream)
            return Shard(songs, rows, *out, ready)

    @torch.inference_mode()
    def sample(waves_i16, real_frames, labels, seed, n_frames, out_frames, steps,
               guidance) -> list[Shard]:
        S = waves_i16.shape[0]
        D = labels.shape[-2] if labels.dim() == 3 else labels.shape[0]
        chunk = args0.latent.chunk_size
        generator = torch.Generator(devices[0]).manual_seed(seed)
        s0 = torch.randn(S * D, args0.style.style_dim, generator=generator, device=devices[0])
        x0 = torch.randn(S * D, out_frames // chunk, args0.diffusion.emb_dim,
                         generator=generator, device=devices[0])
        drawn = None
        if cuda:
            drawn = torch.cuda.Event()
            drawn.record(torch.cuda.current_stream(devices[0]))
        parts = song_shards(S, len(replicas))
        mean = _BatchMean(len(parts))
        futures = []
        for k, songs in enumerate(parts):
            rows = slice(songs.start * D, songs.stop * D)
            futures.append(pool.submit(shard, k, songs, rows, waves_i16, real_frames, labels, s0,
                                       x0, drawn, mean, n_frames, out_frames, steps, guidance))
        errors = [e for e in (f.exception() for f in futures) if e is not None]
        if errors:  # the shard that failed, not the others' broken barrier
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return [f.result() for f in futures]

    sample.devices = devices
    sample.close = pool.shutdown  # the replicas' threads end
    return sample


def gather_shards(shards: Sequence[Shard]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """a sharded batch's (hit_u8, xy_i16, labels f32) on the host in row
    order, once each shard's copies have landed"""
    for s in shards:
        if s.ready is not None:
            s.ready.synchronize()
    return tuple(np.concatenate([np.asarray(getattr(s, name).float() if name == "labels"
                                            else getattr(s, name)) for s in shards])
                 for name in ("hit_u8", "xy_i16", "labels"))
