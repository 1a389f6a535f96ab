"""Dataset build: raw mapsets -> ``data/<audio_hash>/{spec.npy, <id>.map.npy}``.

Copy of osu_dreamer_tpu/data/ingest.py (tests/test_torch_ingest.py holds
its outputs to the original's): ranked-std filtering (mode 0, approved 1),
the spectrogram computed once per audio hash, atomic ``.tmp``-rename writes,
per-map error isolation (one bad map never stops the build), skip-existing
unless ``force``, and untrusted corpus hashes sanitised before they name a
directory.

Two sources:
- ``iter_local_samples``: a local library of ``.osz`` archives and/or
  extracted mapset folders (an osu! ``Songs/`` directory), fully offline;
- ``iter_hf_samples``: the HuggingFace streaming corpus, which needs the
  network and the ``datasets`` package.

The spectrogram runs on ``device`` (``make_spec``: the resonator kernel on
the card); beatmap parsing and encoding fan out over host threads.
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import tempfile
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

# normalized sample shape shared by both sources:
# {
#   "audio_bytes": bytes | None,      # raw audio container bytes
#   "audio_name":  str,               # filename (decides the decoder)
#   "wave":        np.ndarray | None, # pre-decoded mono wave at SR (HF path)
#   "json": {"beatmaps": [{"mode": int, "approved": int,
#                          "beatmap_id": int, "content": str}, ...]},
# }

_AUDIO_RE = re.compile(r"^AudioFilename\s*:\s*(.+?)\s*$", re.MULTILINE)
_MODE_RE = re.compile(r"^Mode\s*:\s*(\d+)\s*$", re.MULTILINE)


def _stable_id(content: str) -> int:
    """deterministic per-difficulty id for local maps (the HF corpus carries
    real beatmap ids; local .osu files often lack a BeatmapID line)"""
    return int.from_bytes(hashlib.md5(content.encode()).digest()[:6], "big")


def _beatmap_entry(content: str) -> dict:
    m = _MODE_RE.search(content)
    return {
        "mode": int(m.group(1)) if m else 0,
        "approved": 1,  # a local library is assumed playable/curated
        "beatmap_id": _stable_id(content),
        "content": content,
    }


def iter_local_samples(songs_dir: Path) -> Iterator[dict]:
    """scan a local mapset library: ``*.osz`` archives and extracted mapset
    folders; one sample per distinct audio file. Junk (bad zips, maps whose
    audio is missing) is skipped, never fatal."""
    for entry in sorted(Path(songs_dir).iterdir()):
        if entry.is_file() and entry.suffix.lower() == ".osz":
            try:
                with zipfile.ZipFile(entry) as z:
                    names = {n for n in z.namelist()}
                    texts = {
                        n: z.read(n).decode("utf-8", errors="replace")
                        for n in names
                        if n.lower().endswith(".osu")
                    }
                    yield from _group_by_audio(
                        texts,
                        lambda name: z.read(name) if name in names else None,
                        available=names,
                    )
            except zipfile.BadZipFile:
                continue
        elif entry.is_dir():
            texts = {
                p.name: p.read_text(encoding="utf-8", errors="replace")
                for p in sorted(entry.glob("*.osu"))
            }

            def read_audio(name: str, d: Path = entry) -> Optional[bytes]:
                p = d / name
                return p.read_bytes() if p.is_file() else None

            available = {p.name for p in entry.iterdir() if p.is_file()}
            yield from _group_by_audio(texts, read_audio, available=available)


def _group_by_audio(
    texts: dict[str, str], read_audio, available: Optional[set] = None
) -> Iterator[dict]:
    # osu! resolves AudioFilename case-insensitively; on a case-sensitive
    # filesystem a .osu saying 'Audio.mp3' for a file named 'audio.mp3' must
    # still match, so resolve through a lowercase-keyed lookup first
    by_lower = {n.lower(): n for n in sorted(available or ())}
    by_audio: dict[str, list[dict]] = {}
    for content in texts.values():
        m = _AUDIO_RE.search(content)
        if not m:
            continue
        name = m.group(1)
        by_audio.setdefault(by_lower.get(name.lower(), name), []).append(
            _beatmap_entry(content)
        )
    for audio_name, beatmaps in sorted(by_audio.items()):
        data = read_audio(audio_name)
        if data is None:
            continue  # audio missing from the set: skip, don't crash
        yield {
            "audio_bytes": data,
            "audio_name": audio_name,
            "wave": None,
            "json": {"beatmaps": beatmaps},
        }


def normalize_hf_sample(sample: dict) -> dict:
    """one raw HF corpus row (post ``cast_column('opus', Audio(SR))``) ->
    the internal sample dict ``build_dataset`` consumes.

    Schema per reference data/dataset.py:42-85: ``sample['opus']['array']``
    holds the decoded wave, ``sample['json']`` carries ``audio_hash`` (the
    corpus's own id, reused as the output directory name) and ``beatmaps``
    rows with mode/approved/beatmap_id/content. Factored out of the
    streaming loop so a recorded fixture page exercises the exact
    normalization the live stream uses (tests/test_torch_ingest.py).
    """
    audio = sample.get("opus") or {}
    wave = np.asarray(audio.get("array", ()), np.float32)
    meta = sample.get("json") or {}
    beatmaps = [
        {
            "mode": int(b.get("mode", 0)),
            "approved": int(b.get("approved", 0)),
            "beatmap_id": int(b.get("beatmap_id", _stable_id(b.get("content", "")))),
            "content": b.get("content", ""),
        }
        for b in meta.get("beatmaps", [])
    ]
    return {
        "audio_bytes": None,
        "audio_name": str(audio.get("path") or "audio.opus"),
        "wave": wave,
        "audio_hash": meta.get("audio_hash"),
        "json": {"beatmaps": beatmaps},
    }


def iter_hf_samples(
    dataset_name: str = "project-riz/osu-beatmaps",
    config: str = "compressed",
) -> Iterator[dict]:
    """stream the HF beatmap corpus (reference dataset.py:34-38: all splits
    concatenated, opus decoded at SR). Requires network egress; the
    normalization itself is fixture-tested offline — prefer ``--songs-dir``
    for local libraries."""
    from ..audio.constants import SR

    try:
        from datasets import Audio, load_dataset
    except ImportError as e:  # pragma: no cover - dep gated
        raise RuntimeError(
            "HF streaming ingest needs the `datasets` package; for an "
            "offline build pass --songs-dir with a local mapset library"
        ) from e

    splits = load_dataset(dataset_name, config, streaming=True)
    for split in splits.values():
        split = split.cast_column("opus", Audio(sampling_rate=SR))
        for sample in split:
            yield normalize_hf_sample(sample)


# -------------------------------------------------------------------- build --


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _decode_audio(sample: dict) -> np.ndarray:
    from ..audio.decode import load_wave

    if sample["wave"] is not None:
        return sample["wave"]
    suffix = Path(sample["audio_name"]).suffix or ".bin"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(sample["audio_bytes"])
        tmp = Path(f.name)
    try:
        return load_wave(tmp)
    finally:
        tmp.unlink(missing_ok=True)


def _spec_frames(spec_file: Path) -> int:
    with open(spec_file, "rb") as f:
        return np.load(f).shape[1]


def build_dataset(
    data_dir: Path,
    num_workers: int = 2,
    force: bool = False,
    songs_dir: Optional[Path] = None,
    samples: Optional[Iterator[dict]] = None,
    device="cuda",
) -> Iterator[int]:
    """preprocess every source sample into the on-disk training layout,
    yielding 1 per map written (drives the CLI's count).

    Idempotent: existing spec/map files are skipped byte- and mtime-stable
    unless ``force``. The spectrogram for a mapset is computed once, on
    ``device`` (a CUDA card unless ``cpu`` is asked for), and only when some
    output under its audio hash is missing.
    """
    from ..audio.constants import get_frame_times
    from ..audio.decode import AudioDecodeError
    from ..audio.io import write_spec
    from ..audio.spectrogram import make_spec
    from ..osu import Beatmap, BeatmapParseError
    from ..signal.encoding import write_beatmap
    from ..utils.device import resolve_device

    device = resolve_device(device, "build the dataset")
    data_dir = Path(data_dir)
    data_dir.mkdir(parents=True, exist_ok=True)
    if samples is None:  # explicit `samples` = recorded fixture / test feed
        samples = iter_local_samples(songs_dir) if songs_dir else iter_hf_samples()

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for sample in samples:
            beatmaps = [
                b
                for b in sample["json"]["beatmaps"]
                if b["mode"] == 0 and b["approved"] == 1
            ]
            if not beatmaps:
                continue

            # the HF corpus carries its own audio_hash (reference
            # dataset.py:42: it names the output directory); local ingest
            # derives one from the audio bytes
            audio_hash = sample.get("audio_hash")
            # the hash comes from UNTRUSTED corpus metadata and names a
            # directory: anything but a plain token (path separators, "..")
            # is replaced with a hash of itself so it cannot escape data_dir
            if audio_hash and not all(
                c.isalnum() or c in "._-" for c in str(audio_hash)
            ):
                audio_hash = hashlib.md5(str(audio_hash).encode()).hexdigest()[:16]
            if audio_hash and set(str(audio_hash)) <= {"."}:
                audio_hash = None  # "." / ".." resolve inside/above data_dir
            if not audio_hash:
                payload = sample["audio_bytes"]
                if payload is None:
                    payload = np.ascontiguousarray(sample["wave"]).tobytes()
                audio_hash = hashlib.md5(payload).hexdigest()[:16]
            out_dir = data_dir / str(audio_hash)
            spec_file = out_dir / "spec.npy"

            todo = [
                b
                for b in beatmaps
                if force or not (out_dir / f"{b['beatmap_id']}.map.npy").exists()
            ]
            need_spec = force or not spec_file.exists()
            if not todo and not need_spec:
                continue

            if need_spec:
                try:
                    wave = _decode_audio(sample)
                except AudioDecodeError:
                    continue  # undecodable audio: skip the whole set
                if len(wave) == 0:
                    continue
                spec = make_spec(wave, device)
                out_dir.mkdir(exist_ok=True)
                buf = io.BytesIO()
                write_spec(buf, spec)
                _atomic_write(spec_file, buf.getvalue())
                n_frames = spec.shape[1]
            else:
                n_frames = _spec_frames(spec_file)

            frame_times = get_frame_times(n_frames)

            def encode_one(b: dict, _ft=frame_times, _dir=out_dir) -> int:
                try:
                    bm = Beatmap(b["content"])
                    buf = io.BytesIO()
                    write_beatmap(buf, bm, _ft)
                except (BeatmapParseError, ValueError):
                    return 0  # per-map isolation (reference dataset.py:87-96)
                _atomic_write(_dir / f"{b['beatmap_id']}.map.npy", buf.getvalue())
                return 1

            for written in pool.map(encode_one, todo):
                if written:
                    yield 1
