"""Host-side audio IO: WAV / NIST SPHERE decode, resampling, writing (port
of ``stac_st_tpu/data/audio.py``).

* RIFF/WAVE: PCM 8/16/24/32-bit, IEEE float32/64, µ-law, A-law;
* NIST SPHERE: PCM 16-bit (big/little), µ-law — the Fisher/CALLHOME format;
* resampling: scipy's polyphase filter (Kaiser-windowed), through
  :func:`..data.resample.fast_resample_poly` for one channel.

These are the numpy paths that the JAX package calls authoritative; its
native decoders (``_stacnative``) and the compressed-container decoder
(``_stacaudio``) are not ported, so a compressed file raises
``ValueError`` as the JAX package does when ``_stacaudio`` is not built.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

from .resample import fast_resample_poly

__all__ = ["read_audio", "read_wav", "read_sphere", "write_wav", "resample"]

# ---------------------------------------------------------------- µ-law/A-law
_ULAW_BIAS = 0x84


def _ulaw_decode(data: np.ndarray) -> np.ndarray:
    u = ~data.astype(np.uint8)
    sign = u & 0x80
    exponent = (u >> 4) & 0x07
    mantissa = u & 0x0F
    sample = ((mantissa.astype(np.int32) << 3) + _ULAW_BIAS) << exponent
    sample -= _ULAW_BIAS
    return np.where(sign > 0, -sample, sample).astype(np.int16)


def _alaw_decode(data: np.ndarray) -> np.ndarray:
    a = data.astype(np.uint8) ^ 0x55
    sign = a & 0x80
    exponent = (a >> 4) & 0x07
    mantissa = (a & 0x0F).astype(np.int32)
    sample = np.where(
        exponent == 0,
        (mantissa << 4) + 8,
        ((mantissa << 4) + 0x108) << np.maximum(exponent - 1, 0),
    )
    return np.where(sign > 0, -sample, sample).astype(np.int16)


def _pcm_to_float(x: np.ndarray, bits: int) -> np.ndarray:
    return (x.astype(np.float32) / float(2 ** (bits - 1))).clip(-1.0, 1.0)


def _pcm16_bytes(data: bytes, big_endian: bool = False) -> np.ndarray:
    dtype = ">i2" if big_endian else "<i2"
    return _pcm_to_float(np.frombuffer(data, dtype), 16)


def _ulaw_bytes(data: bytes) -> np.ndarray:
    return _pcm_to_float(_ulaw_decode(np.frombuffer(data, np.uint8)), 16)


def _alaw_bytes(data: bytes) -> np.ndarray:
    return _pcm_to_float(_alaw_decode(np.frombuffer(data, np.uint8)), 16)


# ----------------------------------------------------------------------- WAV
def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples (n,) or (n, ch) float32 in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize)
            if csize % 2:
                f.read(1)
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, rate, _br, _ba, bits = fmt
    if audio_fmt == 0xFFFE and len(data) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1  # assume PCM subformat (most common)
    if audio_fmt == 1:  # PCM
        if bits == 8:
            samples = _pcm_to_float(
                np.frombuffer(data, np.uint8).astype(np.int16) - 128, 8
            )
        elif bits == 16:
            samples = _pcm16_bytes(data)
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = _pcm_to_float(ints, 24)
        elif bits == 32:
            samples = _pcm_to_float(np.frombuffer(data, "<i4"), 32)
        else:
            raise ValueError(f"{path}: unsupported PCM bits {bits}")
    elif audio_fmt == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(data, dtype).astype(np.float32)
    elif audio_fmt == 7:  # µ-law
        samples = _ulaw_bytes(data)
    elif audio_fmt == 6:  # A-law
        samples = _alaw_bytes(data)
    else:
        raise ValueError(f"{path}: unsupported WAV format {audio_fmt}")
    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, rate


# -------------------------------------------------------------------- SPHERE
def read_sphere(path: str) -> Tuple[np.ndarray, int]:
    """NIST SPHERE reader (LDC Fisher/CALLHOME telephone audio)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.read(8).strip())
        f.seek(0)
        header = f.read(header_size).decode("latin-1")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.strip().split(None, 2)
            if len(parts) == 3 and parts[1].startswith("-"):
                key, typ, value = parts
                fields[key] = int(value) if typ.startswith("-i") else value
            elif line.strip() == "end_head":
                break
        rate = int(fields.get("sample_rate", 8000))
        channels = int(fields.get("channel_count", 1))
        n_bytes = int(fields.get("sample_n_bytes", 2))
        coding = str(fields.get("sample_coding", "pcm"))
        byte_fmt = str(fields.get("sample_byte_format", "01"))
        f.seek(header_size)
        data = f.read()
    if "shorten" in coding:
        raise NotImplementedError(
            f"{path}: shorten-compressed SPHERE requires external "
            "decompression (run `sph2pipe` first, as LDC distributes it)"
        )
    if "ulaw" in coding or "mu-law" in coding:
        samples = _ulaw_bytes(data)
    elif n_bytes == 2:
        samples = _pcm16_bytes(data, big_endian=(byte_fmt == "10"))
    elif n_bytes == 1:
        samples = _ulaw_bytes(data)
    else:
        raise ValueError(f"{path}: unsupported SPHERE coding {coding}")
    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, rate


def read_audio(
    path: str, sample_rate: Optional[int] = None, mono: bool = True
) -> Tuple[np.ndarray, int]:
    """Dispatch on container; optionally resample + downmix (librosa-style)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"RIFF"):
        samples, rate = read_wav(path)
    elif magic.startswith(b"NIST_1A"):
        samples, rate = read_sphere(path)
    else:
        raise ValueError(
            f"{path}: unknown audio container (only RIFF/WAVE and NIST "
            "SPHERE are decoded)")
    if mono and samples.ndim > 1:
        samples = samples.mean(axis=1)
    if sample_rate is not None and sample_rate != rate:
        samples = resample(samples, rate, sample_rate)
        rate = sample_rate
    return samples.astype(np.float32), rate


def resample(samples: np.ndarray, orig_rate: int, new_rate: int) -> np.ndarray:
    g = np.gcd(int(orig_rate), int(new_rate))
    up, down = int(new_rate) // g, int(orig_rate) // g
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        return fast_resample_poly(samples, up, down)
    from scipy.signal import resample_poly

    return resample_poly(
        samples.astype(np.float64), up, down, axis=0
    ).astype(np.float32)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write PCM16 WAV."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    else:
        channels = samples.shape[1]
    pcm = (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    data = pcm.tobytes()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        byte_rate = sample_rate * channels * 2
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                            byte_rate, channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)
