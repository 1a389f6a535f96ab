"""The port's ``load_wave`` against the JAX one on the CPU, on WAV files
written here: 8-, 16-, 24- and 32-bit PCM, 32-bit float and
WAVE_FORMAT_EXTENSIBLE float, mono and stereo, at 16 384 Hz (no resampling)
and 44 100 Hz.

Tolerance: on the numpy path (both packages' ``native`` pinned off) the
waves are equal. On the native path the port's library, built by its own
binding, is held to the JAX binding's code loading the same library: within
1e-6. A file that is not audio raises ``AudioDecodeError`` in both packages
when neither the libav shim nor an ``ffmpeg`` binary is there.
"""

from __future__ import annotations

import shutil
import struct
from pathlib import Path

import numpy as np
import pytest

FORMATS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "ext_float32"]


def write_wav(path: Path, wave: np.ndarray, rate: int, fmt: str) -> None:
    """(frames, channels) float wave in [-1, 1] -> a RIFF/WAVE file"""
    channels = wave.shape[1]
    flat = wave.reshape(-1)
    if fmt == "pcm8":
        payload, code, bits = np.round(flat * 127 + 128).astype(np.uint8).tobytes(), 1, 8
    elif fmt == "pcm16":
        payload, code, bits = np.round(flat * 32767).astype("<i2").tobytes(), 1, 16
    elif fmt == "pcm24":
        as_i32 = np.round(flat * (2**23 - 1)).astype("<i4")
        payload = as_i32.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        code, bits = 1, 24
    elif fmt == "pcm32":
        payload, code, bits = np.round(flat * (2**31 - 1)).astype("<i4").tobytes(), 1, 32
    else:
        payload, code, bits = flat.astype("<f4").tobytes(), 3, 32
    block = channels * bits // 8
    fmt_body = struct.pack("<HHIIHH", code, channels, rate, rate * block, block, bits)
    if fmt == "ext_float32":
        # cbSize 22, valid bits, channel mask, then the SubFormat GUID whose
        # leading u16 is the real format code (3: IEEE float)
        guid = struct.pack("<H", 3) + bytes.fromhex("000000001000800000aa00389b71")
        fmt_body = (struct.pack("<HHIIHH", 0xFFFE, channels, rate, rate * block, block, bits)
                    + struct.pack("<HHI", 22, bits, 0x3 if channels == 2 else 0x4) + guid)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
    body += b"data" + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _wave(seed: int, rate: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = rate // 5
    t = np.arange(n) / rate
    tone = 0.5 * np.sin(2 * np.pi * 440.0 * t)[:, None] + rng.normal(0, 0.1, (n, channels))
    return np.clip(tone, -0.99, 0.99)


CASES = [(fmt, ch, rate) for fmt in FORMATS for ch in (1, 2) for rate in (16384, 44100)]


def _ids(case) -> str:
    fmt, ch, rate = case
    return f"{fmt}-{'mono' if ch == 1 else 'stereo'}-{rate}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_load_wave_python_path_matches_jax(tmp_path, monkeypatch, case):
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu.audio.decode import load_wave as jload
    from osu_dreamer_tpu_torch import native as tnative
    from osu_dreamer_tpu_torch.audio.decode import load_wave as tload

    fmt, ch, rate = case
    path = tmp_path / "song.wav"
    write_wav(path, _wave(len(fmt) + ch, rate, ch), rate, fmt)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    got, want = tload(path), jload(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert len(got) == -(-len(_wave(0, rate, ch)) * 16384 // rate)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_load_wave_native_path_matches_jax(tmp_path, monkeypatch, case):
    """the port's binding and library against the JAX binding's code on the
    same library (built from the same source with the same flags)"""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the port's native library cannot be built here")
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu.audio.decode import load_wave as jload
    from osu_dreamer_tpu_torch import native as tnative
    from osu_dreamer_tpu_torch.audio.decode import load_wave as tload

    assert tnative.available()
    monkeypatch.setattr(jnative, "_LIB_PATH", tnative.build("osudreamer_native.cpp"))
    monkeypatch.setattr(jnative, "_lib", None)
    fmt, ch, rate = case
    path = tmp_path / "song.wav"
    write_wav(path, _wave(len(fmt) + ch, rate, ch), rate, fmt)
    got, want = tload(path), jload(path)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and the native path decodes what the numpy path decodes (before
    # resampling, whose filters differ)
    if rate == 16384:
        monkeypatch.setattr(tnative, "available", lambda: False)
        np.testing.assert_allclose(tload(path), got, rtol=0, atol=1e-6)


def test_non_audio_raises_without_shim_or_ffmpeg(tmp_path, monkeypatch):
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu.audio import decode as jdecode
    from osu_dreamer_tpu_torch import native as tnative
    from osu_dreamer_tpu_torch.audio import decode as tdecode

    path = tmp_path / "notes.txt"
    path.write_text("not audio at all\n" * 10)
    monkeypatch.setattr(jnative, "av_available", lambda: False)
    monkeypatch.setattr(tnative, "av_available", lambda: False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(tdecode.AudioDecodeError, match="ffmpeg"):
        tdecode.load_wave(path)
    with pytest.raises(jdecode.AudioDecodeError, match="ffmpeg"):
        jdecode.load_wave(path)


@pytest.mark.parametrize("what", ["truncated", "no_data_chunk", "pcm12"])
def test_bad_wav_raises_as_jax(tmp_path, monkeypatch, what):
    """the numpy parser's refusals: the same error in both packages"""
    from osu_dreamer_tpu import native as jnative
    from osu_dreamer_tpu.audio import decode as jdecode
    from osu_dreamer_tpu_torch import native as tnative
    from osu_dreamer_tpu_torch.audio import decode as tdecode

    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    path = tmp_path / "bad.wav"
    write_wav(path, _wave(0, 16384, 1), 16384, "pcm16")
    data = path.read_bytes()
    if what == "truncated":
        data = data[:40]
    elif what == "no_data_chunk":
        data = data[:36] + b"LIST" + data[40:]
    else:
        data = data[:34] + struct.pack("<H", 12) + data[36:]
    path.write_bytes(data)
    errors = []
    for decode in (tdecode, jdecode):
        with pytest.raises(decode.AudioDecodeError) as info:
            decode.load_wave(path)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
