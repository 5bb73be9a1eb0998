"""pyannote speaker-change baseline (manifest-driven, reference semantics).

A port of ``stac_st_tpu/eval/pyannote_baseline.py``: the same RTTM lines
and the same gate, with the model on ``device`` (``cuda`` unless the
caller passes ``device="cpu"``). The local backend is the port's
:mod:`.pyannote_local`.

Re-owns ``evaluations/pyannote/eval_pyannote.py``: iterate a frozen manifest,
run either the full ``pyannote/speaker-diarization@2.1`` pipeline
(``min_speakers=1, num_speakers=2`` — :79-88) or the segmentation-model
speaker-change detector (VAD = max-over-speakers + Binarize(onset=0.5);
SCD = |Δprobability| + Peak(alpha=0.05) cropped to the speech timeline —
:95-130), and emit one RTTM keyed by utterance id with the reference's
``:.4f`` line format.

``pyannote.audio`` needs an HF token at model-fetch time and may be
absent; the entry point gates with a clear error (the JAX package's
message, naming the port's modules). Any externally produced RTTM feeds
the same downstream scorer (:mod:`.speaker_change`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..device import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "run_pyannote_baseline",
    "run_pyannote_manifest",
    "rttm_from_pyannote_annotation",
    "store_rttm_file",
]

BATCH_AXIS, TIME_AXIS, SPEAKER_AXIS = 0, 1, 2


def rttm_from_pyannote_annotation(annotation, uri: str) -> List[str]:
    """pyannote Annotation -> RTTM lines (works with any segment iterable
    of (start, duration, label))."""
    lines = []
    try:
        items = [
            (seg.start, seg.duration, label)
            for seg, _, label in annotation.itertracks(yield_label=True)
        ]
    except AttributeError:
        items = list(annotation)
    for start, duration, label in items:
        lines.append(
            f"SPEAKER {uri} 1 {start:.3f} {duration:.3f} "
            f"<NA> <NA> {label} <NA> <NA>"
        )
    return lines


def store_rttm_file(rttm_output: List[str], path: str) -> None:
    with open(path, "w") as f:
        for line in rttm_output:
            f.write(line + "\n")


class _LocalModelLoader:
    """``Model.from_pretrained``-shaped loader for locally built
    checkpoints (:mod:`.pyannote_local`), on the CPU as pyannote's."""

    @staticmethod
    def from_pretrained(path, use_auth_token=None):
        from .pyannote_local import load_local_model

        return load_local_model(path, device="cpu")


class _LocalPipelineLoader:
    """``Pipeline.from_pretrained``-shaped loader for the first-party
    diarization pipeline (segmentation -> embeddings -> clustering,
    :class:`.pyannote_local.LocalDiarizationPipeline`), on the CPU."""

    @staticmethod
    def from_pretrained(path, use_auth_token=None):
        from .pyannote_local import LocalDiarizationPipeline

        return LocalDiarizationPipeline.from_pretrained(path, device="cpu")


def _on_device(obj, device):
    """A loaded pipeline moved to ``device`` (``Pipeline.to``)."""
    return obj.to(device) if hasattr(obj, "to") else obj


def _import_pyannote(backend: str = "pyannote"):
    """Resolve the five objects the model path consumes.

    ``backend="pyannote"`` (default) requires the real package;
    ``backend="local"`` uses the first-party torch backend
    (:mod:`.pyannote_local`) with a locally built
    checkpoint path as ``model_name`` — the Whisper-baseline trick for
    hosts that cannot fetch the gated checkpoints.
    """
    if backend == "local":
        from .pyannote_local import (
            Binarize,
            LocalInference,
            Peak,
        )

        return (LocalInference, _LocalModelLoader, _LocalPipelineLoader,
                Binarize, Peak)
    try:
        from pyannote.audio import Inference, Model, Pipeline  # type: ignore
        from pyannote.audio.utils.signal import Binarize, Peak  # type: ignore
    except ImportError as exc:
        raise RuntimeError(
            "pyannote.audio is not installed in this environment; run this "
            "baseline where it is available, pass backend='local' with a "
            "locally built checkpoint "
            "(stac_st_tpu_torch.eval.pyannote_local."
            "build_local_segmentation_checkpoint), or feed an external RTTM "
            "directly into stac_st_tpu_torch.eval.speaker_change "
            f"(import error: {exc})"
        )
    return Inference, Model, Pipeline, Binarize, Peak


def run_pyannote_manifest(
    manifest_path: str,
    output_rttm: str,
    pipeline: str = "pyannote/segmentation",
    model_name: str = "pyannote/segmentation",
    auth_token: Optional[str] = None,
    data_root: Optional[str] = None,
    backend: str = "pyannote",
    device=None,
) -> List[str]:
    """Reference ``eval_pyannote.main``: manifest → one RTTM keyed by
    utterance id (``:.4f`` fields); the model runs on ``device``."""
    Inference, Model, Pipeline, Binarize, Peak = _import_pyannote(backend)
    dev = resolve_device(device)
    with open(manifest_path) as f:
        gt_data = json.load(f)

    hyp_rttm: List[str] = []
    if pipeline == "pyannote/speaker-diarization@2.1":
        pipe = _on_device(Pipeline.from_pretrained(
            model_name, use_auth_token=auth_token), dev)
        for key, values in gt_data.items():
            wav = values["wav"]
            if data_root:
                wav = wav.replace("{data_root}", data_root)
            diarization = pipe(wav, min_speakers=1, num_speakers=2)
            for turn, _, speaker in diarization.itertracks(yield_label=True):
                hyp_rttm.append(
                    f"SPEAKER {key} 1 {turn.start:.4f} {turn.duration:.4f} "
                    f"<NA> <NA> {speaker} <NA> <NA>"
                )
    else:
        model = Model.from_pretrained(model_name, use_auth_token=auth_token)
        # VAD: max over speaker axis; SCD: |first time-difference| peak
        to_vad = lambda o: np.max(o, axis=SPEAKER_AXIS, keepdims=True)  # noqa: E731
        to_scd = lambda p: np.max(  # noqa: E731
            np.abs(np.diff(p, n=1, axis=TIME_AXIS)),
            axis=SPEAKER_AXIS, keepdims=True,
        )
        vad = Inference(model, pre_aggregation_hook=to_vad, device=dev)
        scd = Inference(model, pre_aggregation_hook=to_scd, device=dev)
        peak = Peak(alpha=0.05)
        binarize = Binarize(onset=0.5)
        for key, values in gt_data.items():
            wav = values["wav"]
            if data_root:
                wav = wav.replace("{data_root}", data_root)
            speech = binarize(vad(wav))
            detected = peak(scd(wav)).crop(speech.get_timeline())
            for turn in detected:
                hyp_rttm.append(
                    f"SPEAKER {key} 1 {turn.start:.4f} {turn.duration:.4f} "
                    f"<NA> <NA> SPK1 <NA> <NA>"
                )

    os.makedirs(os.path.dirname(output_rttm) or ".", exist_ok=True)
    store_rttm_file(hyp_rttm, output_rttm)
    logger.info("pyannote RTTM written to %s (%d lines)",
                output_rttm, len(hyp_rttm))
    return hyp_rttm


def run_pyannote_baseline(
    wav_paths: List[str],
    mode: str = "segmentation",   # segmentation | diarization
    model_path: Optional[str] = None,
    auth_token: Optional[str] = None,
    backend: str = "pyannote",
    device=None,
) -> Dict[str, List[str]]:
    """Per-wav convenience runner: {wav_path: rttm_lines}, the model on
    ``device``."""
    Inference, Model, Pipeline, Binarize, Peak = _import_pyannote(backend)
    dev = resolve_device(device)
    results: Dict[str, List[str]] = {}
    if mode == "diarization":
        pipe = _on_device(Pipeline.from_pretrained(
            model_path or "pyannote/speaker-diarization",
            use_auth_token=auth_token,
        ), dev)
        for wav in wav_paths:
            results[wav] = rttm_from_pyannote_annotation(pipe(wav), wav)
    else:
        model = Model.from_pretrained(
            model_path or "pyannote/segmentation", use_auth_token=auth_token
        )
        to_vad = lambda o: np.max(o, axis=SPEAKER_AXIS, keepdims=True)  # noqa: E731
        to_scd = lambda p: np.max(  # noqa: E731
            np.abs(np.diff(p, n=1, axis=TIME_AXIS)),
            axis=SPEAKER_AXIS, keepdims=True,
        )
        vad = Inference(model, pre_aggregation_hook=to_vad, device=dev)
        scd = Inference(model, pre_aggregation_hook=to_scd, device=dev)
        peak = Peak(alpha=0.05)
        binarize = Binarize(onset=0.5)
        for wav in wav_paths:
            speech = binarize(vad(wav))
            detected = peak(scd(wav)).crop(speech.get_timeline())
            results[wav] = [
                f"SPEAKER {wav} 1 {t.start:.4f} {t.duration:.4f} "
                f"<NA> <NA> SPK1 <NA> <NA>"
                for t in detected
            ]
    return results
