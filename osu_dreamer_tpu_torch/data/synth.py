"""Seeded synthetic corpora for driving training without real data:

- ``write_signal_corpus``: laid out as ``generate-data`` writes it (per
  mapset directory a uint8 ``spec.npy`` (A_DIM, L), per map a ``<id>.map.npy``
  in ``write_beatmap``'s npz format), for ``fit-latent`` and
  ``encode-latents``;
- ``write_latent_corpus``: laid out as ``encode-latents`` writes it (per
  mapset ``h.npy`` (l, A), per map ``<id>.latent.npz`` with ``z`` (l, E),
  ``s`` (S,) and ``labels`` (5,)), for ``fit-denoiser`` without a trained
  latent stage.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..audio.constants import A_DIM
from ..signal.constants import HIT_DIM, NUM_LABELS
from ..signal.encoding import HIT_DTYPE, XY_DTYPE


def write_signal_corpus(root: str | Path, n_mapsets: int, maps_per_set: int, length: int,
                        seed: int = 0) -> Path:
    """-> ``root``. A mapset's spectrogram is uniform noise; a map's hit
    channels are sparse full-strength pulses, its cursor a random walk in the
    unit square, quantized as ``write_beatmap`` quantizes it, its labels
    uniform in [0, 10]"""
    rng = np.random.default_rng(seed)
    root = Path(root)
    for m in range(n_mapsets):
        d = root / f"set{m:04d}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "spec.npy", rng.integers(0, 256, (A_DIM, length), dtype=np.uint8))
        for i in range(maps_per_set):
            hit = (rng.random((HIT_DIM, length)) < 0.05) * np.iinfo(HIT_DTYPE).max
            xy = np.clip(0.5 + np.cumsum(rng.normal(0, 0.01, (2, length)), axis=1), 0, 1)
            xy_min = xy.min(axis=1, keepdims=True)
            xy_rng = xy.max(axis=1, keepdims=True) - xy_min
            xy_rng[xy_rng == 0.0] = 1.0
            # through a file handle: np.savez given a path would append .npz
            with open(d / f"{i}.map.npy", "wb") as f:
                np.savez(
                    f, allow_pickle=False,
                    hit=hit.astype(HIT_DTYPE),
                    xy=np.round((xy - xy_min) / xy_rng * np.iinfo(XY_DTYPE).max).astype(XY_DTYPE),
                    xy_min=xy_min, xy_rng=xy_rng,
                    labels=rng.uniform(0, 10, NUM_LABELS),
                )
    return root


def write_latent_corpus(root: str | Path, n_mapsets: int, maps_per_set: int, length: int,
                        a_dim: int, emb_dim: int, style_dim: int, seed: int = 0) -> Path:
    """-> ``root``; every array is f32 drawn from ``seed``"""
    rng = np.random.default_rng(seed)
    root = Path(root)
    for m in range(n_mapsets):
        d = root / f"set{m:04d}"
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "h.npy", rng.random((length, a_dim), dtype=np.float32))
        for i in range(maps_per_set):
            z = rng.standard_normal((length, emb_dim), dtype=np.float32)
            z /= np.sqrt((z * z).mean(-1, keepdims=True))  # per-frame RMS 1, as the latents
            np.savez(d / f"{i}.latent.npz", z=z,
                     s=rng.standard_normal(style_dim, dtype=np.float32),
                     labels=rng.uniform(0, 10, NUM_LABELS).astype(np.float32))
    return root
