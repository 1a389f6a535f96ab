"""ctypes binding of the C++ host runtime (native/osudreamer_native.cpp at the
root of the checkout) for the port.

Counterpart of osu_dreamer_tpu/native/__init__.py with the same entry points
(``wav_decode``, ``resample``, ``star_rating``, ``odn_fit_slider``'s
argtypes, ``av_decode``, ``av_tags``; the resonator is the port's CUDA
kernel). It builds its own libraries from the same sources with the
Makefile's flags, so the port's fitter computes what the JAX library computes
bit for bit; it never writes into the JAX package. The build runs at first
use with ``g++`` into ``build/native/``, each library named by a hash of its
source, the flags, the compiler's version and its resolved ``-march=native``
target (a library built by another compiler or for another CPU is never
loaded), in a temporary file moved into place, so concurrent first users
each load a whole library.

``available()`` is False when no ``g++`` is found; the numpy paths of the
consumers then serve. A compiler that is found and fails raises. The libav
shim (native/audiodecode_av.cpp) is built where the FFmpeg headers are, as
the Makefile's ``HAVE_AV`` test decides; ``av_available()`` is False
elsewhere.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from ctypes import POINTER, c_double, c_float, c_int32, c_int64, c_uint8
from functools import cache
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCES = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]
AV_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]
# native/Makefile's HAVE_AV test
AV_HEADERS = (Path("/usr/include/x86_64-linux-gnu/libavformat/avformat.h"),
              Path("/usr/include/libavformat/avformat.h"))


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("channels", c_int32),
        ("sample_rate", c_int32),
        ("n_frames", c_int64),
    ]


@cache
def _target(cxx: str) -> bytes:
    """the compiler's version and what ``-march=native`` resolves to here"""
    return b"".join(subprocess.run([cxx, *flags], capture_output=True, check=True).stdout
                    for flags in (["--version"], ["-march=native", "-Q", "--help=target"]))


def build(source: str, libs: tuple[str, ...] = ()) -> Path | None:
    """-> the library built from ``native/<source>`` (compiled now unless
    up to date), or None when no ``g++`` is found; a failed build raises"""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    src = SOURCES / source
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join([*CXXFLAGS, *libs]).encode())
    digest.update(_target(cxx))
    lib = BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / lib.name
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(src), *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@cache
def _load() -> ctypes.CDLL | None:
    path = build("osudreamer_native.cpp")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))

    lib.odn_wav_info.argtypes = [POINTER(c_uint8), c_int64, POINTER(_WavInfo)]
    lib.odn_wav_info.restype = c_int32
    lib.odn_wav_decode.argtypes = [POINTER(c_uint8), c_int64, POINTER(c_float)]
    lib.odn_wav_decode.restype = c_int32
    lib.odn_resample_out_len.argtypes = [c_int64, c_int32, c_int32]
    lib.odn_resample_out_len.restype = c_int64
    lib.odn_resample.argtypes = [
        POINTER(c_float), c_int64, c_int32, c_int32, POINTER(c_float),
    ]
    lib.odn_resample.restype = c_int32
    lib.odn_star_rating.argtypes = [
        POINTER(c_double), POINTER(c_double), POINTER(c_double), c_int64, c_double,
    ]
    lib.odn_star_rating.restype = c_double
    lib.odn_fit_slider.argtypes = [
        POINTER(c_double), c_int64, c_double,           # pts, L, inv_two_var
        c_double, POINTER(c_double), c_int32,           # lp_arc, lp_single, max_single
        POINTER(c_double), POINTER(c_double), c_int32,  # lp_poly_line, lp_poly_bez, max_seg
        ctypes.c_char_p, POINTER(c_double),             # out_type, out_length
        POINTER(c_double), POINTER(c_int32),            # out_ctrl, out_n_ctrl
    ]
    lib.odn_fit_slider.restype = c_int32
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(POINTER(c_float))


def wav_decode(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF bytes -> ((frames, channels) float32, sample_rate)"""
    lib = _load()
    assert lib is not None
    buf = np.frombuffer(data, np.uint8)
    info = _WavInfo()
    rc = lib.odn_wav_info(buf.ctypes.data_as(POINTER(c_uint8)), len(buf), ctypes.byref(info))
    if rc != 0:
        raise ValueError(f"native wav parse failed ({rc})")
    out = np.empty(info.n_frames * info.channels, np.float32)
    rc = lib.odn_wav_decode(buf.ctypes.data_as(POINTER(c_uint8)), len(buf), _fptr(out))
    if rc != 0:
        raise ValueError(f"native wav decode failed ({rc})")
    return out.reshape(info.n_frames, info.channels), info.sample_rate


def resample(wave: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    wave = np.ascontiguousarray(wave, np.float32)
    n_out = lib.odn_resample_out_len(len(wave), rate_in, rate_out)
    out = np.empty(n_out, np.float32)
    rc = lib.odn_resample(_fptr(wave), len(wave), rate_in, rate_out, _fptr(out))
    if rc != 0:
        raise ValueError(f"native resample failed ({rc})")
    return out


def star_rating(times: np.ndarray, xs: np.ndarray, ys: np.ndarray, cs: float) -> float:
    lib = _load()
    assert lib is not None
    t = np.ascontiguousarray(times, np.float64)
    x = np.ascontiguousarray(xs, np.float64)
    y = np.ascontiguousarray(ys, np.float64)
    dptr = lambda a: a.ctypes.data_as(POINTER(c_double))
    return float(lib.odn_star_rating(dptr(t), dptr(x), dptr(y), len(t), cs))


# ------------------------------------------------- libav decode shim --


@cache
def _load_av() -> ctypes.CDLL | None:
    if not any(h.exists() for h in AV_HEADERS):
        return None
    path = build("audiodecode_av.cpp", tuple(AV_LIBS))
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:  # system libav missing at runtime
        return None
    lib.odn_av_decode.argtypes = [
        ctypes.c_char_p, c_int32, POINTER(POINTER(c_float)),
    ]
    lib.odn_av_decode.restype = c_int64
    lib.odn_av_free.argtypes = [POINTER(c_float)]
    lib.odn_av_free.restype = None
    lib.odn_av_tags.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, c_int32,
    ]
    lib.odn_av_tags.restype = c_int32
    return lib


def av_available() -> bool:
    return _load_av() is not None


def av_decode(path: str | Path, target_sr: int) -> np.ndarray:
    """decode any libav-supported audio file -> mono float32 at target_sr"""
    lib = _load_av()
    assert lib is not None
    out_ptr = POINTER(c_float)()
    n = lib.odn_av_decode(str(path).encode(), target_sr, ctypes.byref(out_ptr))
    if n < 0:
        raise ValueError(f"libav decode failed for {path} (code {n})")
    try:
        wave = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    finally:
        lib.odn_av_free(out_ptr)
    return wave


def av_tags(path: str | Path) -> tuple[str, str]:
    """(title, artist) container tags via libavformat (ID3 / Vorbis
    comments / MP4 atoms); empty strings when absent"""
    lib = _load_av()
    assert lib is not None
    title = ctypes.create_string_buffer(512)
    artist = ctypes.create_string_buffer(512)
    rc = lib.odn_av_tags(str(path).encode(), title, artist, 512)
    if rc != 0:
        return "", ""
    return (
        title.value.decode("utf-8", errors="replace"),
        artist.value.decode("utf-8", errors="replace"),
    )
