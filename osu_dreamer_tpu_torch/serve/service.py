"""Map-generation service: load-once artifact, cross-request batching.

Counterpart of osu_dreamer_tpu/serve/service.py on the CUDA cards. A resident
process that owns the cards and keeps them busy under concurrent load:

- loads the inference artifact once onto the card (``load_inference``) and
  builds the kernel library in the constructor, so a failing ``nvcc`` fails
  the start and the first request carries no build;
- serves on every visible card by default, as the JAX service's data mesh
  does: ``devices`` (default all) is clamped to ``max_batch``, ``max_batch``
  is rounded up to a multiple of it, the model is replicated once a card
  (parallel/replicas.py) and each dispatch's songs are split over the
  replicas (``build_sharded_sampler``: one host thread, stream and event a
  card);
- runs ONE dispatcher thread that does all device work: the waves' upload
  from pinned memory, the launches and the result copies. Request threads
  touch only numpy, the pinned host buffers and a CUDA event;
- batches concurrent requests that share a signature (wave bucket,
  #difficulties, steps, guidance) through the sampler ``predict`` uses
  (``build_batch_sampler``); per-song difficulty labels ride the LDM's
  (S, D, NUM_LABELS) path so batched requests keep their own conditioning;
- runs a batch at its own size: nothing is compiled per batch size here, so
  the JAX service's padding to a power of two would only waste rows
  (``padded_rows`` stays in the stats and reads 0);
- hands each waiter its row slice of pinned host buffers the copies land in,
  and a CUDA event recorded after them, WITHOUT synchronising: the
  dispatcher goes on to the next batch while this one computes, and the
  request thread waits on the event, then decodes and zips.

Requests with an explicit seed are never co-batched: the sampler draws one
noise tensor per batch from one ``torch.Generator``, so reproducibility
requires a fixed batch composition. A seeded request runs solo; unseeded
requests share seeds from the server's counter.
"""

from __future__ import annotations

import io
import os
import tempfile
import threading
import time
import zipfile
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

DEFAULT_DIFF = (5.0, 9.0, 8.0, 4.0, 6.0)
# per-request work bounds for a resident multi-tenant service
MAX_SAMPLE_STEPS = 512
MAX_DIFFS = 16
_AUDIO_SUFFIXES = frozenset({".wav", ".mp3", ".ogg", ".opus", ".m4a", ".flac"})


def _safe_entry_name(name: str) -> str:
    """user-supplied audio filename -> a safe zip-entry / tempfile name:
    basename only (zip-slip), printable chars, known audio suffix"""
    base = Path(str(name or "").replace("\\", "/")).name
    base = "".join(c for c in base if c.isprintable() and c not in ':"')
    stem, suffix = Path(base).stem, Path(base).suffix.lower()
    if not stem or stem in (".", ".."):
        stem = "audio"
    if suffix not in _AUDIO_SUFFIXES:
        suffix = ".wav"
    return stem + suffix


def clamp_devices(devices: Optional[int], visible: int, max_batch: int) -> tuple[int, int]:
    """the JAX service's clamp -> (devices served on, max_batch): every
    visible device unless ``devices`` says fewer, at most ``max_batch`` of
    them, and ``max_batch`` rounded up to a multiple of the count"""
    n_dev = visible if devices is None else max(1, min(devices, visible))
    n_dev = min(n_dev, max_batch)
    return n_dev, -(-max_batch // n_dev) * n_dev


@dataclass
class _Pending:
    """one request's device-side work unit"""

    buf: np.ndarray          # int16 bucket-padded wave
    real_frames: int
    n_frames: int
    out_frames: int
    L: int                   # true frame count (crop length)
    labels: np.ndarray       # (D, 5) float32
    steps: int
    guidance: float
    seed: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    # row slices of the batch's host buffers, set at dispatch in the
    # sampler's quantized transfer format ((D, Lp, 7) uint8, (D, Lp, 2)
    # int16; dequantize_chart reassembles). On the card they are pinned
    # buffers the copies are still landing in until ``ready`` has happened;
    # the slices keep the buffers alive until the request thread has read them
    chart: Optional[tuple[torch.Tensor, torch.Tensor]] = None
    pred_labels: Optional[torch.Tensor] = None      # (D, 5)
    ready: Optional[torch.cuda.Event] = None        # None off the card
    error: Optional[BaseException] = None

    @property
    def signature(self) -> tuple:
        return (
            self.n_frames, self.out_frames, len(self.labels),
            self.steps, self.guidance,
        )


class GeneratorService:
    """resident generation service over one inference artifact.

    ``generate`` is thread-safe and blocking: call it from as many request
    threads as you like; the dispatcher batches compatible requests. Runs on
    ``device``, a CUDA card unless the caller asks for the CPU.
    """

    def __init__(
        self,
        model_path: str | Path,
        *,
        max_batch: int = 4,
        batch_window_ms: float = 25.0,
        infer_tempo: bool = False,
        snap_divisor: int = 0,
        devices: Optional[int] = None,
        serialize_workers: Optional[int] = None,
        device: torch.device | str = "cuda",
        replica_devices: Optional[Sequence[torch.device | str]] = None,
    ):
        """``devices``: how many cards to serve on (default every visible
        one), clamped as the JAX service clamps. ``replica_devices`` lists
        the replicas' devices in place of the first visible cards; it may
        repeat a device, so that one card or the CPU serves the sharded path
        (tests and chip_smoke.py; not on the CLI)"""
        from .. import native
        from ..models.inference.artifact import load_inference
        from ..models.inference.sampler import build_batch_sampler, build_sharded_sampler
        from ..parallel import replicas as rep

        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = resolve_device(device, "serve")
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the JAX service's clamp: every visible device unless told, at most
        # max_batch of them, and max_batch a multiple of the count; every
        # dispatch's songs are split over one replica a device
        if replica_devices is None:
            self.devices_visible = torch.cuda.device_count() if cuda else 1
        else:
            replica_devices = [torch.device(d) for d in replica_devices]
            self.devices_visible = len(replica_devices)
        n_dev, self.max_batch = clamp_devices(devices, self.devices_visible, max_batch)
        self.n_devices = n_dev

        self.model = load_inference(model_path, self.device)
        self.chunk = self.model.args.latent.chunk_size
        self._sharded = None
        if n_dev > 1:
            listed = rep.replica_devices(n_dev) if replica_devices is None else replica_devices
            self._sharded = build_sharded_sampler(rep.replicate(self.model, listed[:n_dev]))
        self.batch_window = batch_window_ms / 1000.0
        self.infer_tempo = infer_tempo
        self.snap_divisor = int(snap_divisor)
        if cuda:
            from ..ops import _build

            _build.library()  # nvcc now: a failing build fails the start

        # .osu decode pool: the per-request host tail (peak-pick + slider
        # MAP fit) is GIL-bound — on a multi-core host it must fan out over
        # processes or the service tops out at ~1 core of decode regardless
        # of the card's headroom. Default: one worker per core up to 4; 1
        # core -> no pool (spawn overhead with no parallelism to gain)
        if serialize_workers is None:
            serialize_workers = min(4, os.cpu_count() or 1)
        # build the fitter's library now, before the workers look for it
        native.available()
        self._pool = None
        if serialize_workers > 1:
            from ..utils.procpool import spawn_serialize_pool

            self._pool = spawn_serialize_pool(serialize_workers)
        self.serialize_workers = serialize_workers if self._pool else 1

        self._sample = build_batch_sampler(self.model)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[_Pending] = []
        self._closed = False
        self._seed_counter = int.from_bytes(os.urandom(4), "big")

        # observability
        self.stats_lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "batched_rows": 0,        # rows dispatched
            "padded_rows": 0,         # always 0: batches run at their own size
            "errors": 0,
            "compiled_signatures": 0,  # distinct batch shapes seen
            "started_at": time.time(),
        }
        self._seen_programs: set[tuple] = set()

        self._dispatcher = threading.Thread(
            target=self._run, name="osu-dreamer-dispatcher", daemon=True
        )
        self._dispatcher.start()

    # ------------------------------------------------------------- device --

    def _next_seed(self, seed: Optional[int]) -> int:
        if seed is not None:
            return seed
        with self._lock:
            self._seed_counter += 1
            return self._seed_counter % (2**31)

    # --------------------------------------------------------- dispatcher --

    def _take_batch(self) -> Optional[list[_Pending]]:
        """block for the first request, then widen within the batch window"""
        with self._cond:
            while not self._pending and not self._closed:
                self._cond.wait(timeout=0.1)
            if self._closed and not self._pending:
                return None
            first = self._pending.pop(0)

        batch = [first]
        if first.seed is not None or self.max_batch == 1:
            return batch  # seeded requests run solo (reproducibility)

        deadline = time.monotonic() + self.batch_window
        sig = first.signature
        while len(batch) < self.max_batch:
            with self._cond:
                i = 0
                while i < len(self._pending) and len(batch) < self.max_batch:
                    r = self._pending[i]
                    if r.seed is None and r.signature == sig:
                        batch.append(self._pending.pop(i))
                    else:
                        i += 1
            remaining = deadline - time.monotonic()
            if len(batch) >= self.max_batch or remaining <= 0:
                break
            with self._cond:
                self._cond.wait(timeout=min(remaining, 0.005))
        return batch

    def _run(self) -> None:
        cuda = self.device.type == "cuda"
        with torch.cuda.device(self.device) if cuda else nullcontext():
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                try:
                    self._dispatch(batch)
                except BaseException as e:  # noqa: BLE001 — failures go to waiters
                    for r in batch:
                        r.error = e
                        r.done.set()
                    with self.stats_lock:
                        self.stats["errors"] += len(batch)

    def _dispatch(self, batch: list[_Pending]) -> None:
        cuda = self.device.type == "cuda"
        waves = torch.from_numpy(np.stack([r.buf for r in batch]))
        real = torch.tensor([r.real_frames for r in batch])
        # (S, D, 5): per-song conditioning
        labels = torch.from_numpy(np.stack([r.labels for r in batch]).astype(np.float32))
        first = batch[0]
        seed = self._next_seed(first.seed)

        program = (len(batch),) + first.signature
        fresh = program not in self._seen_programs
        self._seen_programs.add(program)
        D = len(first.labels)
        if self._sharded is not None:
            # each shard's waiters get its slices and its event
            for shard in self._sharded(waves, real, labels, seed, first.n_frames,
                                       first.out_frames, first.steps, first.guidance):
                for i in range(shard.songs.stop - shard.songs.start):
                    r = batch[shard.songs.start + i]
                    rows = slice(i * D, (i + 1) * D)
                    r.chart = (shard.hit_u8[rows], shard.xy_i16[rows])
                    r.pred_labels = shard.labels[rows]
                    r.ready = shard.ready
                    r.done.set()
            self._count(batch, fresh)
            return
        if cuda:
            waves, real, labels = (t.pin_memory().to(self.device, non_blocking=True)
                                   for t in (waves, real, labels))
        generator = torch.Generator(self.device).manual_seed(seed)

        out = self._sample(
            waves, real, labels, generator,
            first.n_frames, first.out_frames, first.steps, first.guidance,
        )
        ready = None
        if cuda:
            # start the copies into pinned host buffers now and hand each
            # waiter its slice and the event WITHOUT synchronising: the
            # dispatcher is free to submit the next batch while this one
            # computes and while request threads decode
            out = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        .copy_(t, non_blocking=True) for t in out)
            ready = torch.cuda.Event()
            ready.record()
        hit_q, xy_q, pred_labels = out
        for i, r in enumerate(batch):
            r.chart = (hit_q[i * D : (i + 1) * D], xy_q[i * D : (i + 1) * D])
            r.pred_labels = pred_labels[i * D : (i + 1) * D]
            r.ready = ready
            r.done.set()
        self._count(batch, fresh)

    def _count(self, batch: list[_Pending], fresh: bool) -> None:
        with self.stats_lock:
            self.stats["batches"] += 1
            self.stats["batched_rows"] += len(batch)
            if fresh:
                self.stats["compiled_signatures"] += 1

    # ------------------------------------------------------------ request --

    def generate(
        self,
        audio_bytes: bytes,
        *,
        audio_name: str = "audio.wav",
        diffs: Optional[Sequence[Sequence[float]]] = None,
        sample_steps: int = 8,
        style_guidance: float = 1.0,
        seed: Optional[int] = None,
        title: Optional[str] = None,
        artist: Optional[str] = None,
        timeout: Optional[float] = 600.0,
        infer_tempo: Optional[bool] = None,
        snap_divisor: Optional[int] = None,
    ) -> tuple[str, bytes]:
        """generate one mapset -> (suggested .osz filename, zip bytes).

        Blocking; safe to call from many threads. ``diffs`` is a list of
        (sr, ar, od, cs, hp) rows — one .osu per row. ``infer_tempo`` /
        ``snap_divisor`` override the service-level defaults per request
        (None = use the default); they only affect the host-side decode, so
        requests with different values still co-batch on the device.
        """
        from ..audio.constants import HOP_LEN
        from ..audio.decode import load_wave
        from ..audio.spectrogram import prep_wave_for_model
        from ..models.inference.sampler import dequantize_chart
        from ..signal.serialize import decode_osu_entry

        if self._closed:
            raise RuntimeError("service is closed")
        diff_rows = np.asarray(
            diffs if diffs is not None and len(diffs) else [DEFAULT_DIFF],
            np.float32,
        )
        if diff_rows.ndim != 2 or diff_rows.shape[1] != 5:
            raise ValueError("each diff row must be (sr, ar, od, cs, hp)")
        if len(diff_rows) > MAX_DIFFS or not np.isfinite(diff_rows).all():
            raise ValueError(f"at most {MAX_DIFFS} finite diff rows per request")
        if snap_divisor is not None and snap_divisor < 0:
            raise ValueError("snap_divisor must be >= 0")
        # a resident service must bound per-request device work: a huge step
        # count would wedge the single dispatcher
        if not 1 <= int(sample_steps) <= MAX_SAMPLE_STEPS:
            raise ValueError(f"sample_steps must be in [1, {MAX_SAMPLE_STEPS}]")
        if not np.isfinite(style_guidance) or not 0.0 <= float(style_guidance) <= 50.0:
            raise ValueError("style_guidance must be a finite value in [0, 50]")

        # host prep on the request thread (decode may need a real file path
        # for the container demuxer)
        audio_name = _safe_entry_name(audio_name)
        suffix = Path(audio_name).suffix or ".wav"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tf:
            tf.write(audio_bytes)
            tmp = Path(tf.name)
        try:
            wave = load_wave(tmp)
        finally:
            tmp.unlink(missing_ok=True)
        buf, real_frames, n_frames, out_frames = prep_wave_for_model(
            wave, self.chunk
        )
        L = max(1, -(-len(wave) // HOP_LEN))

        req = _Pending(
            buf=buf, real_frames=real_frames, n_frames=n_frames,
            out_frames=out_frames, L=L, labels=diff_rows,
            steps=int(sample_steps), guidance=float(style_guidance), seed=seed,
        )
        # enqueue under the lock WITH the closed re-check: a request that
        # slips in after close() would otherwise never be dispatched and
        # hang for the full timeout
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            self._pending.append(req)
            self._cond.notify_all()
        with self.stats_lock:
            self.stats["requests"] += 1

        if not req.done.wait(timeout=timeout):
            with self._cond:
                if req in self._pending:  # never dispatched: withdraw
                    self._pending.remove(req)
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise RuntimeError("generation failed") from req.error

        # wait for the batch's host copies, then the CPU tail on the request
        # thread (deferred device errors surface here, not in the dispatcher)
        try:
            if req.ready is not None:
                req.ready.synchronize()
            chart = dequantize_chart(req.chart[0].numpy(), req.chart[1].numpy())
            pred_labels = req.pred_labels.float().numpy()
        except Exception as e:
            with self.stats_lock:
                self.stats["errors"] += 1
            raise RuntimeError("generation failed on device") from e
        title = title or Path(audio_name).stem
        artist = artist or "Unknown Artist"
        signals = chart[:, : req.L].transpose(0, 2, 1)  # (D, X, L)
        it = self.infer_tempo if infer_tempo is None else infer_tempo
        sd = self.snap_divisor if snap_divisor is None else snap_divisor
        jobs = [
            (title, artist, audio_name, i, row, sig)
            for i, (row, sig) in enumerate(zip(pred_labels, signals))
        ]
        if self._pool is not None:
            # fan the per-diff decode over the pool: requests share it, so a
            # multi-core host scales decode across concurrent requests too
            rs = [
                self._pool.apply_async(
                    decode_osu_entry, j,
                    {"infer_tempo": it, "snap_divisor": sd},
                )
                for j in jobs
            ]
            entries = [r.get() for r in rs]
        else:
            entries = [
                decode_osu_entry(*j, infer_tempo=it, snap_divisor=sd)
                for j in jobs
            ]

        out = io.BytesIO()
        with zipfile.ZipFile(out, "w") as z:
            z.writestr(audio_name, audio_bytes)
            for name, text in entries:
                z.writestr(name, text)
        return f"{artist} - {title}.osz", out.getvalue()

    # ------------------------------------------------------------- admin ---

    def health(self) -> dict[str, Any]:
        return {
            "ok": not self._closed,
            "backend": "gpu" if self.device.type == "cuda" else "cpu",
            "devices": self.n_devices,
            "devices_visible": self.devices_visible,
            "chunk": self.chunk,
            "max_batch": self.max_batch,
            "serialize_workers": self.serialize_workers,
            "uptime_s": round(time.time() - self.stats["started_at"], 1),
        }

    def snapshot_stats(self) -> dict[str, Any]:
        with self.stats_lock:
            out = dict(self.stats)
        with self._cond:
            out["queued"] = len(self._pending)
        return out

    def close(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._closed = True
            stranded = list(self._pending)
            self._pending.clear()
            self._cond.notify_all()
        for r in stranded:  # fail waiters instead of letting them time out
            r.error = RuntimeError("service closed")
            r.done.set()
        self._dispatcher.join(timeout=timeout)
        if self._sharded is not None:
            self._sharded.close()
        if self._pool is not None:
            self._pool.close()
            self._pool.join()
            self._pool = None
