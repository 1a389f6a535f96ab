"""encode-latents: cache the latent encodings stages 2 and 3 train on.

Counterpart of osu_dreamer_tpu/cli/commands.py ``encode_latents``. From a
``fit-latent`` checkpoint of this package (``state.pt`` + ``meta.json``), for
every ``<id>.map.npy`` under the data directory it writes, beside it:
- per mapset ``h.npy`` (n_latent, h_dim), the audio encoder's features;
- per map ``<id>.latent.npz`` with ``z`` (n_latent, emb_dim), ``s``
  (style_dim,) and the map's ``labels``,
with n_latent = ceil(L / chunk). Inputs are bucket-padded (edge replication)
to a multiple of chunk * 64 frames; the uint8 spectrogram travels to the
device quantized and is dequantised there as ``read_spec`` does. Existing
outputs are kept unless ``force``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ...data.pipeline import pad_to_multiple
from ...signal.encoding import read_beatmap
from ...train.checkpoint import load_train_checkpoint
from ...utils import dataclass_from_dict
from ...utils.device import resolve_device
from .model import LatentModel, LatentModelArgs

BUCKET_CHUNKS = 64


def load_latent_model(ckpt_path: str | Path, device: torch.device, dtype: torch.dtype
                      ) -> LatentModel:
    """the model of a ``fit-latent`` checkpoint directory, on ``device``"""
    state, hparams = load_train_checkpoint(ckpt_path)
    model = LatentModel(dataclass_from_dict(LatentModelArgs, hparams["model"]), dtype)
    model.load_state_dict(state["params"])
    return model.to(device).eval()


def encode_latents(ckpt_path: str | Path, data_dir: str | Path, force: bool = False,
                   device: torch.device | str = "cuda") -> int:
    """-> the number of maps encoded"""
    device = resolve_device(device, "encode")
    map_files = sorted(Path(data_dir).rglob("*.map.npy"))
    if not map_files:
        raise FileNotFoundError(f"no pre-processed maps found in {data_dir}")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    model = load_latent_model(ckpt_path, device, dtype)
    chunk = model.args.chunk_size
    bucket = chunk * BUCKET_CHUNKS
    h_done: set[Path] = set()
    n = 0
    with torch.inference_mode():
        for map_file in map_files:
            out_file = map_file.with_name(map_file.name.removesuffix(".map.npy") + ".latent.npz")
            h_file = map_file.parent / "h.npy"
            if not force and out_file.exists() and h_file.exists():
                continue
            if (force or not h_file.exists()) and h_file not in h_done:
                with open(map_file.parent / "spec.npy", "rb") as f:
                    spec_u8 = np.load(f).T  # (L, A) uint8
                n_latent = -(-spec_u8.shape[0] // chunk)
                spec = torch.from_numpy(np.ascontiguousarray(pad_to_multiple(spec_u8, bucket)))
                spec = spec[None].to(device).float() / 255.0
                _, h = model.encode_audio(spec)
                np.save(h_file, h[0, :n_latent].float().cpu().numpy())
                h_done.add(h_file)
            with open(map_file, "rb") as f:
                chart_cl, labels = read_beatmap(f)
            chart = chart_cl.T.astype(np.float32)  # (L, X)
            n_latent = -(-chart.shape[0] // chunk)
            chart_t = torch.from_numpy(pad_to_multiple(chart, bucket))[None].to(device)
            z, s = model.encode_chart(chart_t)
            np.savez(out_file, z=z[0, :n_latent].float().cpu().numpy(),
                     s=s[0].float().cpu().numpy(), labels=labels)
            n += 1
    return n
