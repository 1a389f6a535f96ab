"""Weights for the port's LDM: from a flax parameter tree, from a ``.odt``
inference artifact (written by either package), or seeded random; and the
``.odt`` writer, ``save_inference``, that merges the port's three training
checkpoints into one artifact.

The port's modules carry the flax parameter names and layouts, so the flax
tree ``{"params": {"latent", "diffusion", "style"}}`` flattens onto
``LDM.state_dict()`` key for key, the latent model's chart encoder included.
One thing differs: flax ``nn.Conv`` kernels (kh, kw, in, out) become torch's
(out, in, kh, kw). The writer is a copy of osu_dreamer_tpu/models/inference/
artifact.py ``save_inference`` and ``build_artifact_bytes`` in flax's
msgpack layout, so the JAX package's ``load_inference`` reads what it writes
(tests/test_torch_export.py).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ...train.checkpoint import load_train_checkpoint
from ...utils import dataclass_from_dict
from ...utils.device import resolve_device
from ..latent.model import Conv2d
from .model import LDM, LDMArgs

ARTIFACT_VERSION = 1

def default_dtype(device: torch.device) -> torch.dtype:
    """compute dtype as the JAX artifact loader picks it: f32 on the CPU,
    bf16 on an accelerator"""
    return torch.float32 if torch.device(device).type == "cpu" else torch.bfloat16


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = value
    return out


def _conv_kernels(model: torch.nn.Module) -> set[str]:
    """state-dict keys of the kernels held in torch's conv layout"""
    return {f"{name}.kernel" for name, m in model.named_modules() if isinstance(m, Conv2d)}


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16 from a jax/flax reader
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def from_flax_params(tree: dict, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """flax parameter tree (numpy or torch leaves) -> a state dict for
    ``model``, an ``LDM`` or any port module with a flax counterpart. Every
    leaf is consumed exactly once; an unknown leaf, a missing parameter or a
    shape mismatch raises."""
    params = tree.get("params", tree)
    expected = model.state_dict()
    conv_kernels = _conv_kernels(model)
    out: dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(params).items():
        if key not in expected:
            raise KeyError(f"flax leaf {key!r} has no counterpart in the port")
        t = _as_tensor(leaf)
        if key in conv_kernels:
            t = t.permute(3, 2, 0, 1)
        if t.shape != expected[key].shape:
            raise ValueError(f"{key}: flax shape {tuple(t.shape)} != port {tuple(expected[key].shape)}")
        out[key] = t.contiguous()
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"parameters missing from the flax tree: {missing}")
    return out


def to_flax_params(model: torch.nn.Module) -> dict:
    """the inverse of ``from_flax_params``: ``model``'s state dict as a
    flax parameter tree ``{"params": {...}}`` nested by ``.``, conv kernels
    back in flax's (kh, kw, in, out) layout; leaves stay torch tensors"""
    conv_kernels = _conv_kernels(model)
    params: dict = {}
    for key, t in model.state_dict().items():
        *path, name = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        node[name] = (t.permute(2, 3, 1, 0) if key in conv_kernels else t).detach().contiguous()
    return {"params": params}


def _encode_ext(x: Any) -> Any:
    """torch tensors as flax.serialization's msgpack ext record 1: (shape,
    dtype name, raw C-order bytes), bf16 by the name ``bfloat16``"""
    import msgpack

    if not isinstance(x, torch.Tensor):
        raise TypeError(f"cannot serialize {type(x).__name__}")
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        name, raw = "bfloat16", x.view(torch.int16).numpy().tobytes()
    else:
        arr = x.numpy()
        name, raw = arr.dtype.name, arr.tobytes()
    return msgpack.ExtType(1, msgpack.packb((list(x.shape), name, raw), use_bin_type=True))


def build_artifact_bytes(hparams: LDMArgs, ldm_params: dict) -> bytes:
    """``{"version", "hparams" (JSON), "params" (msgpack of the tree)}`` as
    flax's ``msgpack_serialize`` writes it"""
    import msgpack

    payload = {
        "version": ARTIFACT_VERSION,
        "hparams": json.dumps(dataclasses.asdict(hparams)),
        "params": msgpack.packb(ldm_params, default=_encode_ext, use_bin_type=True),
    }
    return msgpack.packb(payload, use_bin_type=True)


def _to_half(tree: dict) -> dict:
    """f32 leaves cast to bf16 (inference computes in bf16 on the card;
    halves the artifact)"""
    return {k: _to_half(v) if isinstance(v, dict)
            else v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in tree.items()}


def save_inference(
    latent_ckpt_path: str | Path,
    denoiser_ckpt_path: str | Path,
    style_ckpt_path: str | Path,
    output_path: str | Path,
    half: bool = False,
    device: torch.device | str = "cuda",
) -> None:
    """merge three training checkpoints (the latent model's live weights,
    the denoiser's and the style prior's EMA weights) into one inference
    artifact, assembled on ``device`` (a CUDA card unless ``cpu`` is asked
    for); ``half`` stores bf16"""
    device = resolve_device(device, "export")
    (latent, latent_hp), (denoiser, denoiser_hp), (style, style_hp) = (
        load_train_checkpoint(p, device)
        for p in (latent_ckpt_path, denoiser_ckpt_path, style_ckpt_path))
    defaults = LDMArgs()
    hparams = LDMArgs(
        latent=dataclass_from_dict(type(defaults.latent), latent_hp["model"]),
        diffusion=dataclass_from_dict(type(defaults.diffusion), denoiser_hp["model"]),
        style=dataclass_from_dict(type(defaults.style), style_hp["model"]),
    )
    parts = {"latent": latent["params"],
             "diffusion": denoiser["ema_params"] or denoiser["params"],
             "style": style["ema_params"] or style["params"]}
    # loading into the LDM checks every key and shape against the hparams
    model = LDM(hparams, torch.float32).to(device)
    model.load_state_dict({f"{part}.{k}": v for part, sd in parts.items() for k, v in sd.items()})
    ldm_params = to_flax_params(model)
    if half:
        ldm_params = _to_half(ldm_params)
    Path(output_path).write_bytes(build_artifact_bytes(hparams, ldm_params))


def _decode_ext(code: int, data: bytes) -> Any:
    """flax.serialization's msgpack ext records: 1 ndarray, 3 numpy scalar,
    each packed as (shape, dtype name, raw bytes)"""
    import msgpack

    if code not in (1, 3):
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        t = torch.frombuffer(bytearray(buffer), dtype=torch.int16).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).copy())
    t = t.reshape(shape)
    return t if code == 1 else t.reshape(())


def _unpack(data: bytes) -> Any:
    import msgpack

    return msgpack.unpackb(data, ext_hook=_decode_ext, raw=False)


def _check_unchunked(tree: Any) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked (> 1 GiB) array leaves are not supported")
        for value in tree.values():
            _check_unchunked(value)


def load_inference(path: str | Path, device: torch.device | str = "cuda",
                   dtype: torch.dtype | None = None) -> LDM:
    """read a ``.odt`` written by ``build_artifact_bytes`` (either package's)
    -> an ``LDM`` on ``device`` (a CUDA card unless ``cpu`` is asked for;
    f32 parameters; compute dtype ``dtype``, by default f32 on the CPU and
    bf16 elsewhere)"""
    device = resolve_device(device, "load")
    payload = _unpack(Path(path).read_bytes())
    if payload.get("version") != ARTIFACT_VERSION:
        raise ValueError(f"unsupported artifact version {payload.get('version')}")
    args = dataclass_from_dict(LDMArgs, json.loads(payload["hparams"]))
    params = _unpack(payload["params"])
    _check_unchunked(params)
    model = LDM(args, dtype or default_dtype(device))
    model.load_state_dict(from_flax_params(params, model))
    return model.to(device).eval()


def init_random(args: LDMArgs, generator: torch.Generator, device: torch.device | str,
                dtype: torch.dtype | None = None) -> LDM:
    """an ``LDM`` with EVERY parameter drawn from ``generator``: fan-in
    scaled normal kernels, gains 1 + 0.1 N, other vectors 0.1 N.

    Unlike flax's init this leaves nothing at zero: zero-initialised FiLM,
    output and gate layers would make every FiLM path and the samplers'
    updates no-ops, and any comparison through them vacuous."""
    model = LDM(args, dtype or default_dtype(device))
    conv_kernels = _conv_kernels(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            draw = torch.randn(p.shape, generator=generator, device=generator.device)
            if name in conv_kernels:
                fan_in = int(np.prod(p.shape[1:]))
                draw = draw / fan_in**0.5
            elif p.dim() >= 2:
                draw = draw / int(np.prod(p.shape[:-1])) ** 0.5
            elif name.endswith("gamma"):
                draw = 1.0 + 0.1 * draw
            else:
                draw = 0.1 * draw
            p.copy_(draw)
    return model.to(device).eval()
