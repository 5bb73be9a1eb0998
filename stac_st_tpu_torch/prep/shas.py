"""Long-form segmentation: pause-based VAD and SHAS pDAC (host-side numpy).

Port of the segmentation half of ``stac_st_tpu/prep/shas.py`` (the
reference's ``datasets/fisher_callhome/run_shas_segmentation.sh`` chain),
which ``STEngine.long_form`` runs before it decodes:

* pause-based VAD (frame 10 ms, aggressiveness 1): WebRTC-style frame
  decisions through the canonical ring-buffer collector (90 % voiced over a
  300 ms padding window opens a segment, 90 % unvoiced closes it). The
  decisions come from ``webrtcvad`` where it can be imported, and from
  :class:`EnergyFrameVAD` (the same frame contract, aggressiveness mapped
  to energy thresholds) otherwise, the reference's own choice rule;
* SHAS pDAC over frame speech probabilities: trim low-probability edges,
  then split segments longer than ``max`` at the lowest-probability frame
  that leaves both sides at least ``min`` (global argmin otherwise).
  :func:`speech_probabilities` is the stand-in frame classifier (smoothed
  log-energy through a sigmoid); any frame-probability function can be
  passed instead.

The corpus-preparation rest of the reference module (segmentation YAML
files, wav masking, resegmented manifests) is not ported.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "EnergyFrameVAD", "webrtc_vad_or_fallback", "frame_generator",
    "vad_collector", "pause_based_segments", "speech_probabilities", "pdac",
    "shas_segments",
]

SAMPLERATE = 16000


# ---------------------------------------------------------------------------
# frame-level VAD
# ---------------------------------------------------------------------------

class EnergyFrameVAD:
    """Frame classifier with the webrtcvad interface
    (``is_speech(frame_int16, sample_rate) -> bool``).

    Aggressiveness 0-3 maps to increasingly strict energy thresholds
    (WebRTC's GMM is not reproducible without the extension; the contract —
    10/20/30 ms frames, mono 16-bit PCM, higher aggressiveness = fewer
    speech frames — is)."""

    _THRESHOLDS_DB = {0: -55.0, 1: -45.0, 2: -38.0, 3: -32.0}

    def __init__(self, aggressiveness: int = 1):
        if aggressiveness not in self._THRESHOLDS_DB:
            raise ValueError("aggressiveness must be 0-3")
        self.threshold_db = self._THRESHOLDS_DB[aggressiveness]

    def is_speech(self, frame: np.ndarray, sample_rate: int) -> bool:
        x = frame.astype(np.float64) / 32768.0
        energy_db = 10.0 * np.log10(max(float(np.mean(x * x)), 1e-12))
        return energy_db > self.threshold_db


def webrtc_vad_or_fallback(aggressiveness: int = 1):
    """Real webrtcvad when installed, EnergyFrameVAD otherwise."""
    try:
        import webrtcvad  # type: ignore

        vad = webrtcvad.Vad(aggressiveness)

        class _Wrapped:
            def is_speech(self, frame: np.ndarray, sample_rate: int) -> bool:
                return vad.is_speech(frame.tobytes(), sample_rate)

        return _Wrapped()
    except ImportError:
        return EnergyFrameVAD(aggressiveness)


def frame_generator(samples: np.ndarray, sample_rate: int,
                    frame_ms: int) -> List[Tuple[float, np.ndarray]]:
    """Non-overlapping (timestamp_s, int16 frame) list; frame_ms ∈ {10,20,30}
    (the WebRTC contract)."""
    if frame_ms not in (10, 20, 30):
        raise ValueError("frame_ms must be 10, 20 or 30")
    if samples.dtype != np.int16:
        samples = np.clip(samples, -1.0, 1.0)
        samples = (samples * 32767.0).astype(np.int16)
    n = int(sample_rate * frame_ms / 1000)
    return [
        (i * frame_ms / 1000.0, samples[i * n: (i + 1) * n])
        for i in range(len(samples) // n)
    ]


def vad_collector(
    frames: Sequence[Tuple[float, np.ndarray]],
    vad,
    sample_rate: int = SAMPLERATE,
    frame_ms: int = 10,
    padding_ms: int = 300,
    trigger_ratio: float = 0.9,
) -> List[Tuple[float, float]]:
    """Canonical WebRTC ring-buffer collector → (offset_s, duration_s).

    NOTTRIGGERED → TRIGGERED when > trigger_ratio of the padding window is
    voiced (segment opens at the window start); TRIGGERED → NOTTRIGGERED
    when > trigger_ratio is unvoiced (segment closes at the window end)."""
    num_padding = max(1, padding_ms // frame_ms)
    ring: deque = deque(maxlen=num_padding)
    triggered = False
    segments: List[Tuple[float, float]] = []
    seg_start = 0.0
    frame_s = frame_ms / 1000.0

    for ts, frame in frames:
        speech = vad.is_speech(frame, sample_rate)
        ring.append((ts, speech))
        if not triggered:
            if sum(1 for _, s in ring if s) > trigger_ratio * ring.maxlen:
                triggered = True
                seg_start = ring[0][0]
                ring.clear()
        else:
            if sum(1 for _, s in ring if not s) > trigger_ratio * ring.maxlen:
                end = ts + frame_s
                segments.append((seg_start, end - seg_start))
                triggered = False
                ring.clear()
    if triggered and frames:
        end = frames[-1][0] + frame_s
        segments.append((seg_start, end - seg_start))
    return segments


def pause_based_segments(
    samples: np.ndarray,
    sample_rate: int = SAMPLERATE,
    frame_ms: int = 10,
    aggressiveness: int = 1,
    padding_ms: int = 300,
    vad=None,
) -> List[Tuple[float, float]]:
    """In-memory pause-based VAD: samples → (offset_s, duration_s) list
    (the array-level core of :func:`pause_based_segmentation`)."""
    vad = vad if vad is not None else webrtc_vad_or_fallback(aggressiveness)
    frames = frame_generator(samples, sample_rate, frame_ms)
    return vad_collector(frames, vad, sample_rate, frame_ms, padding_ms)


# ---------------------------------------------------------------------------
# SHAS pDAC
# ---------------------------------------------------------------------------

def speech_probabilities(
    samples: np.ndarray,
    sample_rate: int = SAMPLERATE,
    frame_s: float = 0.02,
    smooth_frames: int = 15,
) -> np.ndarray:
    """Stand-in frame speech probabilities for the SHAS classifier (the
    reference downloads ``es_sfc_model_epoch-2.pt``, a wav2vec2-based frame
    classifier — not fetchable offline): smoothed log-energy through a
    sigmoid, 50 Hz frames like the wav2vec2 feature rate."""
    n = int(sample_rate * frame_s)
    m = len(samples) // n
    if m == 0:
        return np.zeros((0,), np.float32)
    energy = (samples[: m * n].astype(np.float64).reshape(m, n) ** 2).mean(1)
    db = 10.0 * np.log10(np.maximum(energy, 1e-12))
    if smooth_frames > 1:
        kernel = np.ones(smooth_frames) / smooth_frames
        db = np.convolve(db, kernel, mode="same")
    return (1.0 / (1.0 + np.exp(-(db + 45.0) / 4.0))).astype(np.float32)


def _trim(start: int, end: int, probs: np.ndarray,
          threshold: float) -> Tuple[int, int]:
    """Strip leading/trailing frames below the probability threshold."""
    while start < end and probs[start] < threshold:
        start += 1
    while end > start and probs[end - 1] < threshold:
        end -= 1
    return start, end


def pdac(
    probs: np.ndarray,
    max_segment_length: float,
    min_segment_length: float,
    frame_s: float = 0.02,
    threshold: float = 0.5,
) -> List[Tuple[float, float]]:
    """Probabilistic divide-and-conquer (SHAS paper, alg. 1): trim, then
    recursively split segments longer than ``max`` at the lowest-probability
    frame keeping both sides ≥ ``min`` (global argmin fallback), trimming
    each side. Returns (offset_s, duration_s)."""
    max_f = max(1, int(round(max_segment_length / frame_s)))
    min_f = max(1, int(round(min_segment_length / frame_s)))
    out: List[Tuple[int, int]] = []

    def recurse(start: int, end: int) -> None:
        start, end = _trim(start, end, probs, threshold)
        if end <= start:
            return
        if end - start <= max_f:
            out.append((start, end))
            return
        lo, hi = start + min_f, end - min_f
        if lo < hi:
            j = start + min_f + int(np.argmin(probs[lo:hi]))
        else:  # min constraint unsatisfiable at this length: global argmin
            j = start + 1 + int(np.argmin(probs[start + 1: end - 1]))
        recurse(start, j)
        recurse(j, end)

    recurse(0, len(probs))
    return [(s * frame_s, (e - s) * frame_s) for s, e in out]


def shas_segments(
    samples: np.ndarray,
    sample_rate: int = SAMPLERATE,
    dac_min_segment_length: float = 10.0,
    dac_max_segment_length: float = 15.0,
    prob_fn: Callable[[np.ndarray, int], np.ndarray] = None,
    frame_s: float = 0.02,
    threshold: float = 0.5,
) -> List[Tuple[float, float]]:
    """In-memory SHAS pDAC: samples → (offset_s, duration_s) list (the
    array-level core of :func:`shas_segmentation`; defaults are the
    reference grid's ``10_15`` point, ``run_shas_segmentation.sh:137``)."""
    probs = (
        prob_fn(samples, sample_rate) if prob_fn is not None
        else speech_probabilities(samples, sample_rate, frame_s)
    )
    return pdac(
        np.asarray(probs), dac_max_segment_length, dac_min_segment_length,
        frame_s, threshold,
    )
