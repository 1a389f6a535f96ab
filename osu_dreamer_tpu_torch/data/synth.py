"""A seeded synthetic cached-latent corpus, laid out as ``encode-latents``
writes it (per mapset directory ``h.npy`` (l, A) and per map
``<id>.latent.npz`` with ``z`` (l, E), ``s`` (S,) and ``labels`` (5,)), for
driving ``fit-denoiser`` without a trained latent stage."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..signal.constants import NUM_LABELS


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
