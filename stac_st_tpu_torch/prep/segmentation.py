"""Long-form segmentation tooling: wav masking, VAD, segments → manifests
(port of ``stac_st_tpu/prep/segmentation.py``).

Re-owns ``datasets/fisher_callhome/{mask_wav_files.py,
create_json_and_segment.py, run_shas_segmentation.sh}``: the
reference masks un-annotated audio to zero, segments full conversations with
an external VAD (WebRTC pause-based, frame 10 ms / aggressiveness 1) or the
SHAS DAC segmenter over a min/max grid, then cuts segment wavs and emits
empty-transcript JSON for inference.

Neither webrtcvad nor the SHAS checkpoint exists in this environment, so the
built-in segmenter is an energy VAD with hangover smoothing plus the same
min/max-duration splitting grid (``10_15 … 10_30`` seconds) — an external
segmenter's output can be fed in as ``segments`` directly, keeping the SHAS
path pluggable.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.audio import read_audio, write_wav

logger = logging.getLogger(__name__)

__all__ = ["mask_wav", "energy_vad", "split_to_grid", "segments_to_json"]


def mask_wav(
    wav_path: str,
    keep_regions: Sequence[Tuple[float, float]],
    out_path: str,
    sample_rate: int = 16000,
) -> None:
    """Zero all audio outside the annotated [start, end) second regions
    (reference ``mask_wav_files.py:54-77``)."""
    samples, rate = read_audio(wav_path, sample_rate=sample_rate)
    mask = np.zeros(len(samples), bool)
    for start, end in keep_regions:
        lo = int(start * sample_rate)
        hi = min(int(end * sample_rate), len(samples))
        mask[lo:hi] = True
    write_wav(out_path, samples * mask, sample_rate)


def energy_vad(
    samples: np.ndarray,
    sample_rate: int = 16000,
    frame_ms: float = 10.0,
    threshold_db: float = -40.0,
    hangover_frames: int = 20,
) -> List[Tuple[float, float]]:
    """Energy VAD with hangover: speech regions in seconds.

    frame_ms matches the reference's WebRTC configuration (10 ms frames,
    ``run_shas_segmentation.sh:113-121``); the hangover plays the role of
    pause-tolerance aggressiveness.
    """
    frame = int(sample_rate * frame_ms / 1000.0)
    n = len(samples) // frame
    if n == 0:
        return []
    energy = (samples[: n * frame].reshape(n, frame) ** 2).mean(axis=1)
    db = 10.0 * np.log10(np.maximum(energy, 1e-12))
    active = db > threshold_db

    # hangover smoothing: keep speech alive across short pauses
    smoothed = active.copy()
    run = 0
    for i in range(n):
        if active[i]:
            run = hangover_frames
        elif run > 0:
            smoothed[i] = True
            run -= 1

    regions: List[Tuple[float, float]] = []
    start = None
    for i, on in enumerate(smoothed):
        if on and start is None:
            start = i
        elif not on and start is not None:
            regions.append((start * frame_ms / 1000.0, i * frame_ms / 1000.0))
            start = None
    if start is not None:
        regions.append((start * frame_ms / 1000.0, n * frame_ms / 1000.0))
    return regions


def split_to_grid(
    regions: Sequence[Tuple[float, float]],
    min_seconds: float = 10.0,
    max_seconds: float = 30.0,
) -> List[Tuple[float, float]]:
    """SHAS-style min/max constraint: merge short regions, split long ones
    (the reference sweeps min_max ∈ {10_15 … 10_30},
    ``run_shas_segmentation.sh:137,217-224``)."""
    out: List[Tuple[float, float]] = []
    pending: Optional[Tuple[float, float]] = None
    for start, end in regions:
        if pending is not None:
            if end - pending[0] <= max_seconds:
                pending = (pending[0], end)
            else:
                out.append(pending)
                pending = (start, end)
        else:
            pending = (start, end)
        if pending[1] - pending[0] >= min_seconds:
            out.append(pending)
            pending = None
    if pending is not None:
        out.append(pending)
    # hard-split anything still over max
    final: List[Tuple[float, float]] = []
    for start, end in out:
        while end - start > max_seconds:
            final.append((start, start + max_seconds))
            start += max_seconds
        if end - start > 0:
            final.append((start, end))
    return final


def segments_to_json(
    wav_path: str,
    segments: Sequence[Tuple[float, float]],
    out_dir: str,
    source_lang: str = "es",
    target_lang: str = "en",
    sample_rate: int = 16000,
    cut_wavs: bool = True,
) -> str:
    """Cut segment wavs + emit an empty-transcript inference manifest
    (reference ``create_json_and_segment.py:18-130``): ids carry absolute
    centisecond offsets so the RTTM chain can reconstruct the clock."""
    recording = os.path.splitext(os.path.basename(wav_path))[0]
    samples, rate = read_audio(wav_path, sample_rate=sample_rate)
    os.makedirs(os.path.join(out_dir, "wav"), exist_ok=True)
    entries: Dict[str, Dict] = {}
    for start, end in segments:
        start_cs, end_cs = int(start * 100), int(end * 100)
        uid = f"{recording}-0-{start_cs:06d}-{end_cs:06d}"
        seg_path = os.path.join(out_dir, "wav", f"{uid}.wav")
        if cut_wavs and not os.path.isfile(seg_path):
            lo = int(start * sample_rate)
            hi = int(end * sample_rate)
            write_wav(seg_path, samples[lo:hi], sample_rate)
        entries[uid] = {
            "wav": seg_path,
            "duration": round(end - start, 3),
            "task": "translation",
            "source_lang": source_lang,
            "target_lang": target_lang,
            "transcription": "",
            "translation_0": "",
        }
    path = os.path.join(out_dir, "data-resegmented-st.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=2, ensure_ascii=False)
    return path
