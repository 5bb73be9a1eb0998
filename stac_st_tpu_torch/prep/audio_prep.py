"""Audio segmentation for corpus prep: cut channel/time windows to 16 kHz wav
(port of ``stac_st_tpu/prep/audio_prep.py``).

Replaces the reference's torchaudio-based ``segment_audio``
(``fisher_callhome_prepare.py:385-407``): read the source recording
(NIST SPHERE for Fisher/CALLHOME, any supported container otherwise),
select the channel, slice ``[start, end)`` centiseconds, resample 8→16 kHz
(numpy polyphase, as the JAX package does) and write PCM16 wav.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import numpy as np

from ..data.audio import read_sphere, read_wav, resample, write_wav

__all__ = ["segment_audio", "load_recording"]


@lru_cache(maxsize=4)
def load_recording(path: str) -> Tuple[np.ndarray, int]:
    """Cached multi-channel read (preps cut many windows per recording)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"NIST_1A"):
        return read_sphere(path)
    return read_wav(path)


def segment_audio(
    audio_path: str,
    channel: int,
    start: int,
    end: int,
    save_path: str,
    sample_rate: int = 16000,
    **unused,
) -> float:
    """Cut [start, end) centiseconds of one channel; returns duration (s)."""
    samples, rate = load_recording(audio_path)
    if samples.ndim > 1:
        if channel < 0:  # downmix both speakers
            samples = samples.mean(axis=1)
        elif channel >= samples.shape[1]:
            raise ValueError(f"{audio_path}: no channel {channel}")
        else:
            samples = samples[:, channel]
    lo = int(start / 100.0 * rate)
    hi = int(end / 100.0 * rate)
    cut = samples[lo:hi]
    if rate != sample_rate:
        cut = resample(cut, rate, sample_rate)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    write_wav(save_path, cut, sample_rate)
    return len(cut) / sample_rate
