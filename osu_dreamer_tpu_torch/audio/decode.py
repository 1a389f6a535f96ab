"""Audio decoding: file -> mono float32 wave at SR = 16384 Hz.

Copy of osu_dreamer_tpu/audio/decode.py, on the port's own ``native``
binding:

1. WAV/RIFF: the C++ decoder and polyphase resampler
   (native/osudreamer_native.cpp) when the library is loaded, else the
   numpy parser below (PCM u8/s16/s24/s32, float32/64, WAVE_FORMAT_EXTENSIBLE,
   any channel count and rate) and ``scipy.signal.resample_poly``;
2. anything else: the libav shim (native/audiodecode_av.cpp, linking the
   system FFmpeg libraries) when it is built;
3. else an ``ffmpeg`` binary on PATH (raw f32le PCM over a pipe);
4. else ``AudioDecodeError``.
"""

from __future__ import annotations

import shutil
import struct
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np

from .constants import SR


class AudioDecodeError(Exception):
    pass


def load_wave(audio_file: str | Path) -> np.ndarray:
    """decode `audio_file` to a mono float32 wave at SR Hz"""
    audio_file = Path(audio_file)
    head = audio_file.open("rb").read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        from .. import native

        if native.available():
            wave, rate = native.wav_decode(audio_file.read_bytes())
            mono = np.ascontiguousarray(wave.mean(axis=1))
            return native.resample(mono, rate, SR) if rate != SR else mono
        wave, rate = _decode_wav(audio_file)
        return resample(wave.mean(axis=1), rate, SR)

    # compressed formats: the first-party libav shim (native/
    # audiodecode_av.cpp, links the system FFmpeg libraries — the same
    # codecs torchcodec wraps for the reference) with an ffmpeg-binary pipe
    # as the fallback
    from .. import native

    if native.av_available():
        try:
            wave = native.av_decode(audio_file, SR)
            if len(wave) > 0:
                return wave
            shim_err: Exception | None = None
        except ValueError as e:
            shim_err = e
        # a file the shim's codec set rejects may still decode through an
        # ffmpeg binary with more codecs compiled in — try before giving up
        import shutil as _shutil

        if _shutil.which("ffmpeg") is not None:
            return _decode_via_ffmpeg(audio_file)
        if shim_err is not None:
            raise AudioDecodeError(str(shim_err)) from shim_err
        raise AudioDecodeError(f"{audio_file}: no audio samples decoded")
    return _decode_via_ffmpeg(audio_file)


# ---------------------------------------------------------------- WAV/RIFF --

_PCM_DECODERS = {
    8: lambda raw: (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0,
    16: lambda raw: np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0,
    32: lambda raw: np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0,
}


def _decode_s24(raw: bytes) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    as_i32 = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    as_i32 = np.where(as_i32 >= 1 << 23, as_i32 - (1 << 24), as_i32)
    return as_i32.astype(np.float32) / float(1 << 23)


def _decode_wav(path: Path) -> tuple[np.ndarray, int]:
    """parse a RIFF/WAVE file -> ((N, channels) float32, sample_rate)"""
    data = path.read_bytes()
    if len(data) < 44:
        raise AudioDecodeError(f"{path}: truncated WAV")

    pos, end = 12, len(data)
    fmt = None
    fmt_body = b""
    payload = None
    while pos + 8 <= end:
        chunk_id = data[pos : pos + 4]
        (chunk_len,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_len]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == b"data":
            payload = body
        pos += 8 + chunk_len + (chunk_len & 1)

    if fmt is None or payload is None:
        raise AudioDecodeError(f"{path}: missing fmt/data chunk")

    wav_format, channels, rate, _byte_rate, _block_align, bits = fmt
    if wav_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the REAL format code is the SubFormat GUID's leading u16, at fmt
        # body offset 24 (16 std + cbSize 2 + valid-bits 2 + channel-mask 4)
        # — IEEE-float extensible files are common DAW/ffmpeg output and
        # would decode to full-scale noise through the int PCM path
        if len(fmt_body) >= 26:
            (wav_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            wav_format = 1  # malformed extensible header: assume PCM

    if wav_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(payload, dt).astype(np.float32)
    elif wav_format == 1:  # integer PCM
        if bits == 24:
            samples = _decode_s24(payload)
        elif bits in _PCM_DECODERS:
            samples = _PCM_DECODERS[bits](payload)
        else:
            raise AudioDecodeError(f"{path}: unsupported PCM depth {bits}")
    else:
        raise AudioDecodeError(f"{path}: unsupported WAV format code {wav_format}")

    usable = len(samples) - len(samples) % channels
    return samples[:usable].reshape(-1, channels), rate


# --------------------------------------------------------------- resampling --


def resample(wave: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """polyphase windowed-sinc resampling (Kaiser window)"""
    if rate_in == rate_out:
        return wave.astype(np.float32)
    frac = Fraction(rate_out, rate_in).limit_denominator(1 << 16)
    from scipy.signal import resample_poly

    return resample_poly(wave, frac.numerator, frac.denominator).astype(np.float32)


# ------------------------------------------------------------------ ffmpeg --


def _decode_via_ffmpeg(path: Path) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise AudioDecodeError(
            f"{path}: compressed audio needs an `ffmpeg` binary on PATH "
            "(this build has no bundled codec libraries); convert to WAV first"
        )
    proc = subprocess.run(
        [
            ffmpeg, "-v", "error", "-i", str(path),
            "-f", "f32le", "-ac", "1", "-ar", str(SR), "pipe:1",
        ],
        capture_output=True,
        check=False,
    )
    if proc.returncode != 0:
        raise AudioDecodeError(f"{path}: ffmpeg failed: {proc.stderr.decode()[:500]}")
    return np.frombuffer(proc.stdout, np.float32).copy()
