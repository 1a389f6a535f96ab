"""Weights for the port's LDM: from a flax parameter tree, from a ``.odt``
inference artifact written by the JAX package, or seeded random.

The port's modules carry the flax parameter names and layouts, so the flax
tree ``{"params": {"latent", "diffusion", "style"}}`` flattens onto
``LDM.state_dict()`` key for key, the latent model's chart encoder included.
One thing differs: flax ``nn.Conv`` kernels (kh, kw, in, out) become torch's
(out, in, kh, kw).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ...utils import dataclass_from_dict
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
    """read a ``.odt`` written by osu_dreamer_tpu's ``build_artifact_bytes``
    -> an ``LDM`` on ``device`` (a CUDA card unless ``cpu`` is asked for;
    f32 parameters; compute dtype ``dtype``, by default f32 on the CPU and
    bf16 elsewhere)"""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to load on the CPU")
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
