"""Windowed training streams over the pre-processed and cached-latent datasets.

Copy of osu_dreamer_tpu/data/pipeline.py (pure numpy and ``random.Random``,
pinned by tests/test_torch_data.py to yield the same windows in the same
order for the same seed):

- ``hold_out_mapsets``: validation split by whole mapset (md5 order of the
  directory names), capped by count and fraction;
- ``signal_windows``: random-offset non-overlapping windows of the
  generate-data layout (per mapset ``spec.npy``, per map ``<id>.map.npy``)
  with X/Y flip augmentation, for stage 1;
- ``latent_windows``: the same over the encode-latents cache (per mapset
  ``h.npy``, per map ``<id>.latent.npz`` with ``z``/``s``/``labels``), for
  stages 2 and 3;
- both with a ``max_per_map`` cap and a shuffle buffer; ``seq_len=None``
  streams full maps in a fixed order;
- ``batched``: drop-last stacking; ``prefetch``: a background thread keeps
  the stream ahead of the device; ``pad_to_multiple``: edge replication of
  the time axis.

Samples are time-major / channel-last, (l, C).
"""

from __future__ import annotations

import hashlib
import queue
import random
import threading
from pathlib import Path
from typing import Iterable, Iterator, NamedTuple, Sequence

import numpy as np

from ..audio.io import read_spec
from ..signal.encoding import read_beatmap

Mapset = list[Path]  # the map files of one mapset (same parent dir)


class SignalSample(NamedTuple):
    """one stage-1 training example, time-major"""

    audio: np.ndarray   # (L, A_DIM) spectrogram in [0, 1]
    chart: np.ndarray   # (L, X_DIM) signal: 7 hit channels + normalized xy
    labels: np.ndarray  # (NUM_LABELS,) sr/ar/od/cs/hp


class LatentSample(NamedTuple):
    """one stage-2/3 training example, time-major at latent rate"""

    h: np.ndarray       # (l, A) audio features
    z: np.ndarray       # (l, E) chart latents
    s: np.ndarray       # (S,) style code
    labels: np.ndarray  # (NUM_LABELS,)


def hold_out_mapsets(
    data_dir: Path,
    pattern: str,
    max_val_count: int,
    max_val_frac: float,
) -> tuple[list[Mapset], list[Mapset]]:
    """-> (train_mapsets, val_mapsets): map files matching ``pattern``
    grouped by mapset directory, with whole mapsets held out for validation
    (shared audio would otherwise leak train->val).

    The split is a deterministic function of each mapset's directory name
    (md5 order), so it is stable across runs, stages, and dataset growth —
    a mapset never migrates between splits because an unrelated set was
    added.
    """
    by_dir: dict[Path, Mapset] = {}
    for f in sorted(Path(data_dir).rglob(pattern)):
        by_dir.setdefault(f.parent, []).append(f)
    if not by_dir:
        raise FileNotFoundError(
            f"no '{pattern}' files under {data_dir}: run `generate-data` "
            "(and `encode-latents` for latent datasets) first"
        )

    dirs = sorted(by_dir)
    n_val = min(int(max_val_count), int(len(dirs) * max_val_frac))
    if n_val == 0 and max_val_count > 0 and max_val_frac > 0 and len(dirs) > 1:
        # small corpora: int(len * frac) rounds to 0, and an empty val split
        # silently disables early stopping / best-checkpointing — floor to 1
        print(
            f"[data] val split rounded to 0 mapsets ({len(dirs)} total, "
            f"max_val_frac={max_val_frac}); holding out 1 mapset instead"
        )
        n_val = 1
    ranked = sorted(dirs, key=lambda d: hashlib.md5(d.name.encode()).hexdigest())
    val_dirs = set(ranked[:n_val])
    train = [by_dir[d] for d in dirs if d not in val_dirs]
    val = [by_dir[d] for d in dirs if d in val_dirs]
    return train, val


def _window_starts(
    length: int, window: int, cap: int, rng: random.Random
) -> list[int]:
    """random-offset, non-overlapping window starts covering one map
    (reference modules/beatmap.py:189-199); ``cap`` < 0 means no cap"""
    n = length // window
    if n <= 0:
        return []
    offset = rng.randrange(length - n * window + 1)
    starts = [offset + i * window for i in range(n)]
    if 0 <= cap < n:
        starts = rng.sample(starts, cap)
    return starts


def _shuffle_buffered(stream: Iterator, buffer_size: int, rng: random.Random):
    """bounded-memory stream shuffling (reference modules/beatmap.py:155-165)"""
    if buffer_size <= 1:
        yield from stream
        return
    buf: list = []
    for item in stream:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        j = rng.randrange(buffer_size)
        yield buf[j]
        buf[j] = item
    rng.shuffle(buf)
    yield from buf


def _apply_shard(mapsets: Sequence[Mapset], shard) -> list[Mapset]:
    if shard is None:
        return list(mapsets)
    num_shards, shard_index = shard
    return list(mapsets)[shard_index::num_shards]


def _read_spec_t(mapset_dir: Path) -> np.ndarray:
    with open(mapset_dir / "spec.npy", "rb") as f:
        return read_spec(f).T.astype(np.float32)  # (L, A)


def _read_chart_t(map_file: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(map_file, "rb") as f:
        chart, labels = read_beatmap(f)
    return chart.T.astype(np.float32), labels.astype(np.float32)  # (L, X), (5,)


def _flip_xy(chart: np.ndarray, rng: random.Random) -> np.ndarray:
    """osu! playfield symmetry augmentation: mirror normalized cursor x
    and/or y; hit channels unchanged"""
    fx, fy = rng.random() < 0.5, rng.random() < 0.5
    if not (fx or fy):
        return chart
    chart = chart.copy()
    if fx:
        chart[:, 7] = 1.0 - chart[:, 7]
    if fy:
        chart[:, 8] = 1.0 - chart[:, 8]
    return chart


def _cap_windows(n: int, cap: int) -> int:
    return n if cap < 0 else min(cap, n)


def count_signal_windows(
    sets: Sequence[Mapset],
    seq_len: int,
    max_per_map: int = -1,
    shard: tuple[int, int] | None = None,
) -> int:
    """number of samples ``signal_windows`` yields for this shard (the random
    offset moves windows but never changes their count), from array headers
    only"""
    total = 0
    for ms in _apply_shard(sets, shard):
        spec_len = np.load(ms[0].parent / "spec.npy", mmap_mode="r").shape[1]
        for f in ms:
            with np.load(f) as npz:
                chart_len = npz["hit"].shape[1]
            total += _cap_windows(min(spec_len, chart_len) // seq_len, max_per_map)
    return total


def count_latent_windows(
    sets: Sequence[Mapset],
    seq_len: int | None,
    max_per_map: int = -1,
    shard: tuple[int, int] | None = None,
) -> int:
    """``count_signal_windows``'s counterpart for the cached-latent stream;
    ``seq_len=None`` counts full maps (the style stage's one-per-map)"""
    total = 0
    for ms in _apply_shard(sets, shard):
        if seq_len is None:
            total += len(ms)
            continue
        h_len = np.load(ms[0].parent / "h.npy", mmap_mode="r").shape[0]
        for f in ms:
            with np.load(f) as npz:
                z_len = npz["z"].shape[0]
            total += _cap_windows(min(h_len, z_len) // seq_len, max_per_map)
    return total


def signal_windows(
    sets: Sequence[Mapset],
    seq_len: int | None,
    *,
    shuffle_buffer: int = 1,
    max_per_map: int = -1,
    seed: int = 0,
    flip_augment: bool = True,
    shard: tuple[int, int] | None = None,
) -> Iterator[SignalSample]:
    """stream (spec window, chart window, labels) training samples;
    ``seq_len=None`` -> full maps in a fixed order, no augmentation. The
    mapset's spectrogram is read once and windows are views into it."""
    mapsets = _apply_shard(sets, shard)

    if seq_len is None:
        for ms in mapsets:
            spec = None
            for f in sorted(ms):
                if spec is None:
                    spec = _read_spec_t(f.parent)
                chart, labels = _read_chart_t(f)
                L = min(len(spec), len(chart))
                yield SignalSample(spec[:L], chart[:L], labels)
        return

    rng = random.Random(seed)

    def gen() -> Iterator[SignalSample]:
        order = list(mapsets)
        rng.shuffle(order)
        for ms in order:
            files = list(ms)
            rng.shuffle(files)
            spec = _read_spec_t(files[0].parent)
            for f in files:
                chart, labels = _read_chart_t(f)
                L = min(len(spec), len(chart))
                for s0 in _window_starts(L, seq_len, max_per_map, rng):
                    w = chart[s0 : s0 + seq_len]
                    if flip_augment:
                        w = _flip_xy(w, rng)
                    yield SignalSample(spec[s0 : s0 + seq_len], w, labels)

    yield from _shuffle_buffered(gen(), shuffle_buffer, rng)


def latent_windows(
    sets: Sequence[Mapset],
    seq_len: int | None,
    *,
    shuffle_buffer: int = 1,
    max_per_map: int = -1,
    seed: int = 0,
    shard: tuple[int, int] | None = None,
) -> Iterator[LatentSample]:
    """stream (h window, z window, s, labels) from the encode-latents cache:
    per-mapset ``h.npy`` + per-map ``<id>.latent.npz``
    (reference modules/latent.py:74-149). ``seq_len=None`` -> full maps."""
    mapsets = _apply_shard(sets, shard)

    def load_h(mapset_dir: Path) -> np.ndarray:
        h_file = mapset_dir / "h.npy"
        if not h_file.exists():
            raise FileNotFoundError(
                f"{h_file} missing — run `encode-latents` before fitting "
                "the denoiser/style stages"
            )
        return np.load(h_file).astype(np.float32)  # (l, A)

    def load_map(f: Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        with np.load(f) as npz:
            return (
                npz["z"].astype(np.float32),
                npz["s"].astype(np.float32),
                npz["labels"].astype(np.float32),
            )

    if seq_len is None:
        for ms in mapsets:
            h = None
            for f in sorted(ms):
                if h is None:
                    h = load_h(f.parent)
                z, s, labels = load_map(f)
                l = min(len(h), len(z))
                yield LatentSample(h[:l], z[:l], s, labels)
        return

    rng = random.Random(seed)

    def gen() -> Iterator[LatentSample]:
        order = list(mapsets)
        rng.shuffle(order)
        for ms in order:
            files = list(ms)
            rng.shuffle(files)
            h = load_h(files[0].parent)
            for f in files:
                z, s, labels = load_map(f)
                l = min(len(h), len(z))
                for s0 in _window_starts(l, seq_len, max_per_map, rng):
                    yield LatentSample(
                        h[s0 : s0 + seq_len], z[s0 : s0 + seq_len], s, labels
                    )

    yield from _shuffle_buffered(gen(), shuffle_buffer, rng)


def batched(stream: Iterable, batch_size: int):
    """stack ``batch_size`` samples field-wise into one batch of the same
    NamedTuple type; drop-last so every batch compiles to one jit shape"""
    buf: list = []
    for sample in stream:
        buf.append(sample)
        if len(buf) == batch_size:
            yield type(buf[0])(*(np.stack(cols) for cols in zip(*buf)))
            buf = []


def pad_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    """replicate-pad axis 0 up to a multiple (the last frame repeated)"""
    pad = -len(x) % multiple
    if pad == 0:
        return x
    return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1), mode="edge")


_END = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(stream: Iterable, depth: int = 2) -> Iterator:
    """run ``stream`` on a background thread, keeping up to ``depth`` items
    ready, so host-side windowing/stacking overlaps device steps; exceptions
    re-raise at the consumer.

    Consumer-abandonment-safe: if the consumer stops early (multi-host
    lockstep truncation islices every epoch; generator close on break), the
    worker notices via a stop flag instead of blocking forever on a full
    queue — otherwise each truncated epoch would leak a thread pinning
    ``depth`` full batches."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stopped = threading.Event()

    def worker() -> None:
        try:
            for item in stream:
                while not stopped.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stopped.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 — must cross the thread
            q.put(_Raised(e))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stopped.set()  # runs on break/close/GC of the consumer generator
