"""CALLHOME Spanish (LDC96S35/T17) preparation: single-turn and multi-turn
(port of ``stac_st_tpu/prep/callhome.py``; byte-equal manifests and wavs).

Re-owns the reference ``callhome_prepare.py`` / ``callhome_prepare_turns.py``:
parse ISO-8859-1 transcripts with ``start end speaker: text`` lines
(A/B speakers → channels 0/1), apply the fisher-callhome-corpus mapping
(``callhome_devtest`` / ``callhome_evltest`` / ``callhome_train``), attach the
single English reference, clean/filter, cut 16 kHz wavs, emit
``data-{asr,st}.json`` (splits devtest / evltest / train —
``callhome_prepare.py:121``). The turns variant mirrors the Fisher one.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from .cleaning import CALLHOME, clean_transcription, finalize_transcription
from .fisher import (
    _attach_translations,
    _filter_lengths,
    _segment_all,
    load_mapping,
    load_translations,
)
from .records import Utterance, write_manifests
from .tdf import parse_callhome
from .turns import concatenate_turns

logger = logging.getLogger(__name__)

__all__ = ["prepare_callhome", "prepare_callhome_turns"]

DATASETS = ["devtest", "evltest", "train"]


def _load_split(dataset: str, transcript_folder: str, speech_folder: str,
                corpus_path: str) -> List[Utterance]:
    mapping = load_mapping(
        os.path.join(corpus_path, "mapping", f"callhome_{dataset}")
    )
    recordings = {uid.split("-")[0] for uid, _ in mapping}
    transcripts = {}
    for rec in sorted(recordings):
        for ext in (".txt", ".cha"):
            path = os.path.join(transcript_folder, f"{rec}{ext}")
            if os.path.isfile(path):
                transcripts[rec] = parse_callhome(
                    path,
                    clean=lambda t: clean_transcription(t, CALLHOME),
                )
                break

    utterances: List[Utterance] = []
    for uid, indices in mapping:
        rec = uid.split("-")[0]
        segs = transcripts.get(rec)
        if not segs:
            continue
        group = segs[indices[0] - 1 : indices[-1]]
        if not group:
            continue
        text = finalize_transcription(
            " ".join(s.transcript for s in group), lang="es"
        )
        start, end = group[0].start, group[-1].end
        utterances.append(Utterance(
            uid=uid,
            wav="",
            duration=(end - start) / 100.0,
            transcription=text,
            source_audio=os.path.join(speech_folder, f"{rec}.sph"),
            channel=group[0].channel,
            start=start,
            end=end,
        ))

    path = os.path.join(corpus_path, "corpus", "ldc",
                        f"callhome_{dataset}.en")
    refs = [load_translations(path)] if os.path.isfile(path) else [[]]
    _attach_translations(utterances, refs)
    return _filter_lengths(utterances, n_refs=1)


def prepare_callhome(
    data_folder: str,
    save_folder: str,
    corpus_path: Optional[str] = None,
    save_suffix: str = "data",
    datasets: Optional[List[str]] = None,
) -> None:
    speech_folder = os.path.join(data_folder, "LDC96S35", "callhome", "spanish",
                                 "speech")
    transcript_folder = os.path.join(data_folder, "LDC96T17",
                                     "callhome_spanish_trans_970711",
                                     "transcrp")
    corpus_path = corpus_path or os.path.join(save_folder,
                                              "fisher-callhome-corpus")
    for dataset in datasets or DATASETS:
        out_dir = os.path.join(save_folder, f"callhome-{dataset}")
        if os.path.isfile(os.path.join(out_dir, f"{save_suffix}-asr.json")):
            logger.info("skipping callhome-%s (done)", dataset)
            continue
        utts = _load_split(dataset, transcript_folder, speech_folder,
                           corpus_path)
        utts.sort(key=lambda u: u.uid)
        utts = _segment_all(utts, os.path.join(out_dir, "wav"))
        write_manifests(utts, out_dir, save_suffix, n_refs=1)
        logger.info("callhome-%s: %d utterances", dataset, len(utts))


def prepare_callhome_turns(
    data_folder: str,
    save_folder: str,
    max_seconds: float,
    corpus_path: Optional[str] = None,
    save_suffix: str = "data-turns",
    datasets: Optional[List[str]] = None,
    turns_channel: str = "ref",
) -> None:
    speech_folder = os.path.join(data_folder, "LDC96S35", "callhome", "spanish",
                                 "speech")
    transcript_folder = os.path.join(data_folder, "LDC96T17",
                                     "callhome_spanish_trans_970711",
                                     "transcrp")
    corpus_path = corpus_path or os.path.join(save_folder,
                                              "fisher-callhome-corpus")
    suffix_sec = f"{int(max_seconds)}s"
    for dataset in datasets or DATASETS:
        out_dir = os.path.join(save_folder,
                               f"callhome-{dataset}-{suffix_sec}")
        if os.path.isfile(os.path.join(out_dir, f"{save_suffix}-asr.json")):
            logger.info("skipping callhome-%s turns (done)", dataset)
            continue
        utts = _load_split(dataset, transcript_folder, speech_folder,
                           corpus_path)
        utts.sort(key=lambda u: (u.recording_id, u.start))
        merged = concatenate_turns(utts, max_seconds)
        merged = [u for u in merged if u.duration < 1.2 * max_seconds]
        channel = 0 if turns_channel == "ref" else -1
        merged = _segment_all(merged, os.path.join(out_dir, "wav"),
                              channel_override=channel)
        write_manifests(merged, out_dir, save_suffix, n_refs=1,
                        with_segments=True)
        logger.info("callhome-%s (%s): %d multi-turn utterances",
                    dataset, suffix_sec, len(merged))
