"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes``. The build
runs at the first CUDA call (never at import: machines without ``nvcc`` import
this package and run the plain PyTorch versions on CPU tensors). The library
lands in ``build/kernels/`` at the root of the checkout, named by a hash of
the sources, so an edited source is rebuilt and a stale library is never
loaded.

Each kernel wrapper adds one to its entry of ``launches`` when it launches its
kernel, so a run can show that the main path went through the kernels. The
replicas of a sharded batch launch from several host threads at once: the
counts and the first build are taken under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from functools import cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

KERNELS = ("resonator", "film_layer", "swiglu", "flash_attention", "swiglu_bwd",
           "fused_attention_fwd", "fused_attention_bwd", "film_layer_bwd", "swiglu_bwd_full",
           "film_qkv_fwd", "film_qkv_bwd", "swiglu_tp", "swiglu_bwd_tp", "film_layer_tp",
           "film_layer_bwd_tp", "long_attention_bwd", "swiglu_bwd_full_tp", "film_qkv_tp",
           "film_qkv_bwd_tp", "qk_prep", "qk_post")
launches: dict[str, int] = {name: 0 for name in KERNELS}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "odt_resonate": [_P] * 7 + [_I, _I, _P],
    "odt_film_layer_fwd": [_P] * 14 + [_I] * 8 + [_P],
    "odt_swiglu_fwd": [_P] * 9 + [_I] * 8 + [_P],
    "odt_ffn_weight_maps": [_P, _P, _I, _I, _P],
    "odt_flash_attention_fwd": [_P] * 4 + [_I, _I, _I, _I, ctypes.c_float, _P],
    "odt_swiglu_bwd": [_P] * 15 + [_I] * 10 + [_P],
    "odt_fused_attention_fwd": [_P] * 7 + [_I, _I, _I, _I, ctypes.c_float, _P],
    "odt_fused_attention_bwd": [_P] * 11 + [_I, _I, _I, _I, ctypes.c_float, _P],
    "odt_film_layer_bwd": [_P] * 28 + [_I] * 11 + [_P],
    "odt_swiglu_bwd_full": [_P] * 19 + [_I] * 12 + [_P],
    "odt_film_qkv_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "odt_film_qkv_bwd": [_P] * 16 + [_I] * 5 + [_P],
    "odt_swiglu_fwd_tp": [_P] * 10 + [_I] * 10 + [_P],
    "odt_film_layer_fwd_tp": [_P] * 16 + [_I] * 9 + [_P],
    "odt_swiglu_bwd_tp": [_P] * 17 + [_I] * 12 + [_P],
    "odt_film_layer_bwd_tp": [_P] * 29 + [_I] * 13 + [_P],
    "odt_attention_stream_fwd": [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "odt_fused_attention_stream_fwd": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
    "odt_fused_attention_stream_bwd": [_P] * 17 + [_I] * 5 + [ctypes.c_float, _P],
    "odt_attention_stream_bwd": [_P] * 11 + [_I] * 5 + [ctypes.c_float, _P],
    "odt_long_attention_bwd": [_P] * 11 + [_I] * 5 + [ctypes.c_float, _P],
    "odt_swiglu_bwd_full_tp": [_P] * 21 + [_I] * 14 + [_P],
    "odt_film_qkv_bwd_tp": [_P] * 17 + [_I] * 6 + [_P],
    "odt_qk_prep": [_P] * 8 + [_I] * 4 + [_P],
    "odt_qk_post": [_P] * 8 + [_L] * 6 + [_P, _P] + [_I] * 4 + [_P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libodt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """compile the kernels unless an up-to-date library exists: one nvcc per
    source, all in parallel, then one link (the compilers' output goes to
    build.log beside it); -> (library path, build seconds, 0 when cached)"""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                 str(CSRC / f"{obj.stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for obj in objs
        ]
        logs = [f"== {obj.stem}.cu\n{proc.communicate()[0]}" for obj, proc in zip(objs, procs)]
        failed = [obj.stem for obj, proc in zip(objs, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp = Path(tmpdir) / lib.name
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    return lib, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """the loaded kernel library (built on first use, by one thread)"""
    with _LOCK:
        return _load()


@cache
def _load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim`` whose data pointer is 16-byte aligned"""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def run(fn_name: str, kernel: str, device: torch.device, *args, count: bool = True) -> None:
    """call a C entry point on ``device``'s current stream, raise on a
    nonzero cudaGetLastError(), count the launch (``count`` False: a later
    phase of a launch already counted, the TP forms' second half)"""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    if count:
        with _LOCK:
            launches[kernel] += 1
