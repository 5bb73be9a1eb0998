"""Fisher Spanish (LDC2010S01/T04) preparation: single-turn and multi-turn
(port of ``stac_st_tpu/prep/fisher.py``; byte-equal manifests and wavs).

Re-owns the reference preps (``fisher_callhome_prepare.py`` /
``fisher_callhome_prepare_turns.py``): parse ``.tdf`` transcripts, apply the
fisher-callhome-corpus mapping files (which regroup tdf lines into the
utterances the translations align to), attach 1 (train) or 4 (dev/dev2/test)
English references, clean text, filter (0 < chars < 400, 0 < dur < 30 s),
cut per-utterance 16 kHz wavs, and emit ``data-{asr,st}.json``.

The turns variant then greedily concatenates consecutive utterances into
≤ ``max_seconds`` windows with ``[turn]``/``[xt]`` markers
(:mod:`.turns`), keeps windows shorter than 1.2 × max, and
emits ``data-turns-{asr,st}.json`` with ``segments_*`` metadata.

The fisher-callhome-corpus translations are an external download
(https://github.com/joshua-decoder/fisher-callhome-corpus); pass its local
checkout via ``corpus_path`` (this environment has no network egress — the
reference git-clones it at prep time, ``fisher_callhome_prepare.py:463-469``).

Behavioral-fidelity notes: the reference's shipped turns
prep overwrites its dataset list to ``["dev"]`` (a debug leftover at
``fisher_callhome_prepare_turns.py:130``); this port restores the full
["dev","dev2","test","train"]. Multi-turn audio follows the reference in
cutting channel 0 of the merged window (``:461-466``); pass
``turns_channel="mix"`` to downmix both speakers instead.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

from .audio_prep import segment_audio
from .cleaning import clean_transcription, finalize_transcription, process_translation
from .records import Utterance, write_manifests
from .tdf import Segment, parse_tdf
from .turns import concatenate_turns

logger = logging.getLogger(__name__)

__all__ = ["prepare_fisher", "prepare_fisher_turns", "load_mapping",
           "load_translations", "apply_mapping"]

DATASETS = ["dev", "dev2", "test", "train"]
SAMPLE_RATE = 16000


def load_mapping(path: str) -> List[tuple]:
    """Mapping lines: ``<uid> <i[_j...]>`` — tdf line groups per utterance."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            indices = [int(x) for x in parts[1].split("_")]
            out.append((parts[0], indices))
    return out


def load_translations(path: str) -> List[str]:
    """Exact reference chain (``fisher_callhome_prepare.py:429-448``): read
    bytes, drop CRs, decode utf-8, then the full clean → normalize → Moses
    normalize → de-punctuate → Moses tokenize pipeline per line."""
    with open(path, "rb") as f:
        raw_lines = f.readlines()
    return [
        process_translation(line.replace(b"\r", b"").decode("utf-8"))
        for line in raw_lines
    ]


def apply_mapping(
    mapping: List[tuple],
    transcripts: Dict[str, List[Segment]],
    speech_folder: str,
) -> List[Utterance]:
    """Regroup tdf lines into translation-aligned utterances."""
    utterances: List[Utterance] = []
    for uid, indices in mapping:
        recording = uid.split("-")[0]
        segs = transcripts.get(recording)
        if segs is None:
            continue
        group = segs[indices[0] - 1 : indices[-1]]  # 1-based inclusive
        if not group:
            continue
        text = finalize_transcription(
            " ".join(s.transcript for s in group), lang="es"
        )
        start, end = group[0].start, group[-1].end
        channel = group[0].channel
        utterances.append(Utterance(
            uid=uid,
            wav="",  # filled after segmentation
            duration=(end - start) / 100.0,
            transcription=text,
            source_audio=os.path.join(speech_folder, f"{recording}.sph"),
            channel=channel,
            start=start,
            end=end,
        ))
    return utterances


def _attach_translations(utterances: List[Utterance],
                         translation_lists: List[List[str]]) -> None:
    for i, utt in enumerate(utterances):
        utt.translations = [
            refs[i] if i < len(refs) else "" for refs in translation_lists
        ]


def _filter_lengths(utterances: List[Utterance], n_refs: int,
                    max_duration: float = 30.0) -> List[Utterance]:
    out = []
    for utt in utterances:
        if not 0 < len(utt.transcription) < 400:
            continue
        refs = utt.translations[:n_refs]
        if any(not 0 < len(r) < 400 for r in refs):
            continue
        if not 0 < utt.duration < max_duration:
            continue
        out.append(utt)
    return out


def _segment_all(utterances: List[Utterance], wav_dir: str,
                 channel_override: Optional[int] = None) -> List[Utterance]:
    kept = []
    for utt in utterances:
        wav_path = os.path.join(wav_dir, f"{utt.uid}.wav")
        if not os.path.exists(wav_path):
            try:
                segment_audio(
                    utt.source_audio,
                    utt.channel if channel_override is None else channel_override,
                    utt.start, utt.end, wav_path, SAMPLE_RATE,
                )
            except (FileNotFoundError, ValueError) as exc:
                logger.warning("skipping %s: %s", utt.uid, exc)
                continue
        utt.wav = wav_path
        kept.append(utt)
    return kept


def _load_split(
    dataset: str, transcription_folder: str, speech_folder: str,
    corpus_path: str,
) -> List[Utterance]:
    mapping = load_mapping(os.path.join(corpus_path, "mapping",
                                        f"fisher_{dataset}"))
    recordings = {uid.split("-")[0] for uid, _ in mapping}
    transcripts = {}
    for rec in sorted(recordings):
        tdf = os.path.join(transcription_folder, f"{rec}.tdf")
        if os.path.isfile(tdf):
            transcripts[rec] = parse_tdf(tdf, clean=clean_transcription)
    utterances = apply_mapping(mapping, transcripts, speech_folder)

    n_refs = 1 if dataset == "train" else 4
    refs = []
    for number in range(n_refs):
        suffix = f".{number}" if n_refs > 1 else ""
        path = os.path.join(corpus_path, "corpus", "ldc",
                            f"fisher_{dataset}.en{suffix}")
        refs.append(load_translations(path) if os.path.isfile(path) else [])
    _attach_translations(utterances, refs)
    return _filter_lengths(utterances, n_refs)


def prepare_fisher(
    data_folder: str,
    save_folder: str,
    corpus_path: Optional[str] = None,
    save_suffix: str = "data",
    datasets: Optional[List[str]] = None,
) -> None:
    """Single-turn Fisher prep → {save}/{split}/data-{asr,st}.json."""
    speech_folder = os.path.join(
        data_folder, "LDC2010T04", "fisher_spa", "data", "speech"
    )
    transcription_folder = os.path.join(
        data_folder, "LDC2010T04", "fisher_spa_tr", "data", "transcripts"
    )
    corpus_path = corpus_path or os.path.join(save_folder,
                                              "fisher-callhome-corpus")
    for dataset in datasets or DATASETS:
        out_dir = os.path.join(save_folder, dataset)
        if os.path.isfile(os.path.join(out_dir, f"{save_suffix}-asr.json")):
            logger.info("skipping %s, completed in previous run", dataset)
            continue
        utts = _load_split(dataset, transcription_folder, speech_folder,
                           corpus_path)
        utts.sort(key=lambda u: u.uid)
        utts = _segment_all(utts, os.path.join(out_dir, "wav"))
        n_refs = 1 if dataset == "train" else 4
        write_manifests(utts, out_dir, save_suffix, n_refs=n_refs)
        logger.info("%s: %d utterances", dataset, len(utts))


def prepare_fisher_turns(
    data_folder: str,
    save_folder: str,
    max_seconds: float,
    corpus_path: Optional[str] = None,
    save_suffix: str = "data-turns",
    datasets: Optional[List[str]] = None,
    turns_channel: str = "ref",
) -> None:
    """Multi-turn Fisher prep → {save}/{split}-{N}s/data-turns-{asr,st}.json."""
    speech_folder = os.path.join(
        data_folder, "LDC2010T04", "fisher_spa", "data", "speech"
    )
    transcription_folder = os.path.join(
        data_folder, "LDC2010T04", "fisher_spa_tr", "data", "transcripts"
    )
    corpus_path = corpus_path or os.path.join(save_folder,
                                              "fisher-callhome-corpus")
    suffix_sec = f"{int(max_seconds)}s"
    for dataset in datasets or DATASETS:
        out_dir = os.path.join(save_folder, f"{dataset}-{suffix_sec}")
        if os.path.isfile(os.path.join(out_dir, f"{save_suffix}-asr.json")):
            logger.info("skipping %s, completed in previous run", dataset)
            continue
        n_refs = 1 if dataset == "train" else 4
        utts = _load_split(dataset, transcription_folder, speech_folder,
                           corpus_path)
        # stream in start-time order per recording for the greedy merge
        utts.sort(key=lambda u: (u.recording_id, u.start))
        merged = concatenate_turns(utts, max_seconds)
        merged = [u for u in merged if u.duration < 1.2 * max_seconds]
        channel = 0 if turns_channel == "ref" else -1  # -1 = downmix
        merged = _segment_all(
            merged, os.path.join(out_dir, "wav"), channel_override=channel
        )
        write_manifests(merged, out_dir, save_suffix, n_refs=n_refs,
                        with_segments=True)
        logger.info("%s (%s): %d multi-turn utterances",
                    dataset, suffix_sec, len(merged))
