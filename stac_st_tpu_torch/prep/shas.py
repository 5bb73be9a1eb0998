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

The corpus-preparation rest follows: one wav through either method to
SHAS's segment dicts (:func:`pause_based_segmentation`,
:func:`shas_segmentation`), the SHAS YAML interchange file,
:func:`mask_wav_files` (every sample outside the ground-truth utterances of
the manifest's keys zeroed) and :func:`create_json_and_segment` (the YAML's
segments filtered against the ground-truth span, cut at 16 kHz and written
as ``data-resegmented-{asr,st}.json`` in the reference's schema). The
output is byte-equal to the JAX package's.
"""

from __future__ import annotations

import json
import logging
import os
from collections import deque
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..data.audio import read_audio, write_wav

logger = logging.getLogger(__name__)

__all__ = [
    "EnergyFrameVAD", "webrtc_vad_or_fallback", "frame_generator",
    "vad_collector", "pause_based_segments", "pause_based_segmentation",
    "speech_probabilities", "pdac", "shas_segments", "shas_segmentation",
    "mask_wav_files", "create_json_and_segment", "write_segmentation_yaml",
    "read_segmentation_yaml",
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


def pause_based_segmentation(
    wav_path: str,
    frame_ms: int = 10,
    aggressiveness: int = 1,
    padding_ms: int = 300,
    vad=None,
) -> List[Dict]:
    """One wav → SHAS-style segment dicts (offset/duration/wav), the
    pause-based method of ``run_shas_segmentation.sh:113-121``."""
    samples, rate = read_audio(wav_path, sample_rate=SAMPLERATE)
    return _segment_dicts(wav_path, pause_based_segments(
        samples, rate, frame_ms, aggressiveness, padding_ms, vad))


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


def shas_segmentation(
    wav_path: str,
    dac_min_segment_length: float,
    dac_max_segment_length: float,
    prob_fn: Callable[[np.ndarray, int], np.ndarray] = None,
    frame_s: float = 0.02,
    threshold: float = 0.5,
) -> List[Dict]:
    """One wav → SHAS segment dicts over the DAC min/max constraint
    (``run_shas_segmentation.sh:217-224``)."""
    samples, rate = read_audio(wav_path, sample_rate=SAMPLERATE)
    return _segment_dicts(wav_path, shas_segments(
        samples, rate, dac_min_segment_length, dac_max_segment_length,
        prob_fn, frame_s, threshold))


def _segment_dicts(wav_path: str, segments) -> List[Dict]:
    """(offset, duration) pairs as the SHAS YAML's segment dicts."""
    name = os.path.basename(wav_path)
    return [{"duration": round(dur, 6), "offset": round(off, 6), "rW": 0,
             "uW": 0, "speaker_id": "NA", "wav": name}
            for off, dur in segments]


# ---------------------------------------------------------------------------
# YAML IO (SHAS interchange format)
# ---------------------------------------------------------------------------

def write_segmentation_yaml(segments: List[Dict], path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(segments, f, default_flow_style=True)


def read_segmentation_yaml(path: str) -> List[Dict]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# ---------------------------------------------------------------------------
# exact ports: mask_wav_files / create_json_and_segment
# ---------------------------------------------------------------------------

def mask_wav_files(ground_truth_json: str, input_folder: str,
                   output_folder: str) -> None:
    """Zero un-annotated audio (exact ``mask_wav_files.py`` semantics: the
    centisecond fields of each manifest KEY define keep regions in samples
    at 16 kHz; output is mono 16-bit PCM)."""
    with open(ground_truth_json) as f:
        dataset_gt = json.load(f)
    start_end: Dict[str, List[List[int]]] = {}
    for key in dataset_gt:
        _id = key.split("-")[0]
        start_frame = int((int(key.split("-")[2]) / 100) * SAMPLERATE)
        end_frame = int((float(key.split("-")[3]) / 100) * SAMPLERATE)
        start_end.setdefault(_id, [[start_frame, end_frame]])
        start_end[_id].append([start_frame, end_frame])

    os.makedirs(output_folder, exist_ok=True)
    for utt_id, regions in start_end.items():
        wav_path = os.path.join(input_folder, f"{utt_id}.wav")
        samples, rate = read_audio(wav_path)
        mask = np.zeros(len(samples), np.float32)
        for lo, hi in regions:
            mask[lo:hi] = 1.0
        write_wav(
            os.path.join(output_folder, f"{utt_id}.wav"),
            samples * mask, rate,
        )


def create_json_and_segment(
    segmentation_file: str,
    base_folder: str,
    data_folder: str,
    output_folder: str,
    cut_wavs: bool = True,
) -> Tuple[str, str]:
    """Exact port of ``create_json_and_segment.py:18-113``: VAD YAML →
    boundary-filtered per-segment wav cuts + ``data-resegmented-{asr,st}.json``
    in the reference's field-for-field schema."""
    ground_truth_data = os.path.join(base_folder, "data.json")
    with open(ground_truth_data) as f:
        dataset_gt = json.load(f)

    start_end_dict: Dict[str, Dict[str, float]] = {}
    for key in dataset_gt:
        _id = key.split("-")[0]
        if _id not in start_end_dict:
            start_end_dict[_id] = {
                "start": float(key.split("-")[2]),
                "end": float(key.split("-")[3]),
            }
        start_end_dict[_id]["end"] = float(key.split("-")[3])

    segmented_data = read_segmentation_yaml(segmentation_file)

    output_json_file_asr: Dict[str, Dict] = {}
    output_json_file_st: Dict[str, Dict] = {}
    os.makedirs(output_folder, exist_ok=True)
    for segmented in segmented_data:
        _id = segmented["wav"].split(".")[0]
        start = int(float(segmented["offset"]) * 100)
        duration = int(float(segmented["duration"]) * 100)
        end = start + duration

        min_start_allowed = start_end_dict[_id]["start"]
        max_end_allowed = start_end_dict[_id]["end"]
        utterance_id = f"{_id}-{0}-{start:06d}-{end:06d}"

        if (start < min_start_allowed and end < min_start_allowed) or (
            start > max_end_allowed and end > max_end_allowed
        ):
            logger.warning("error processing this file %s", utterance_id)
            continue

        wav_path = os.path.join(data_folder, segmented["wav"])
        wav_save_path = os.path.join(
            os.path.abspath(output_folder), utterance_id + ".wav"
        )
        if cut_wavs and not os.path.exists(wav_save_path):
            samples, rate = read_audio(wav_path, sample_rate=SAMPLERATE)
            lo = int(start / 100 * SAMPLERATE)
            hi = int(end / 100 * SAMPLERATE)
            write_wav(wav_save_path, samples[lo:hi], SAMPLERATE)

        for target_lang, task, output_json_file in zip(
            ["es", "en"],
            ["transcription", "translation"],
            [output_json_file_asr, output_json_file_st],
        ):
            output_json_file[utterance_id] = {
                "wav": wav_save_path,
                "source_lang": "es",
                "target_lang": target_lang,
                "segments_start": 0,
                "segments_duration": f"{duration / 100:.2f}",
                "segments_channel": "0",
                "duration": f"{duration / 100:.2f}",
                "task": task,
                "transcription": "",
                "translation_0": "",
            }

    outputs = []
    for task in ["asr", "st"]:
        output_file = os.path.join(base_folder, f"data-resegmented-{task}.json")
        payload = output_json_file_asr if task == "asr" else output_json_file_st
        with open(output_file, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, ensure_ascii=False)
        outputs.append(output_file)
    return outputs[0], outputs[1]
