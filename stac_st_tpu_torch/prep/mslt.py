"""MSLT (Microsoft Speech Language Translation) v1/v1.1 preparation.

A port of ``stac_st_tpu/prep/mslt.py`` (byte-equal manifests, the audio
read by the port's reader). It re-owns ``datasets/mslt/mslt_prepare.py``: the corpus ships per-utterance
WAVs next to UTF-16 sentence files — ``*.T0.<src>.snt`` (raw transcript),
``*.T1.<src>.snt`` (cleaned transcript), ``*.T2.<src>.snt`` (punctuated) and
``*.T3.<tgt>.snt`` (translation). For each (subset, src, tgt) combination we
pair T2 (transcript) with T3 (translation), clean both, and emit joint
ASR+ST manifests in the frozen schema.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Dict, Optional

from .cleaning import mslt_clean_all
from ..data.audio import read_audio

logger = logging.getLogger(__name__)

__all__ = ["prepare_mslt"]


def _read_snt(path: str) -> str:
    """UTF-16 single-sentence files (reference handles zh/ja fixups too)."""
    for encoding in ("utf-16", "utf-8-sig", "utf-8"):
        try:
            with open(path, encoding=encoding) as f:
                return " ".join(line.strip() for line in f if line.strip())
        except (UnicodeError, UnicodeDecodeError):
            continue
    return ""


def prepare_mslt(
    data_folder: str,
    save_folder: str,
    source_lang: str,
    target_lang: str,
    subset: str = "dev",
    transcript_tier: str = "T2",
    translation_tier: str = "T3",
) -> Optional[str]:
    """Emit {save}/mslt_{subset}_{src}_{tgt}/data.json."""
    pattern = os.path.join(data_folder, "**", f"*.{transcript_tier}.*.snt")
    snt_files = sorted(glob.glob(pattern, recursive=True))
    entries: Dict[str, Dict] = {}
    for snt in snt_files:
        base = snt[: snt.index(f".{transcript_tier}.")]
        uid = os.path.basename(base)
        wav = base + f".{source_lang}.wav"
        if not os.path.isfile(wav):
            candidates = glob.glob(base + "*.wav")
            if not candidates:
                continue
            wav = candidates[0]
        translation_files = glob.glob(
            base + f".{translation_tier}.{target_lang}*.snt"
        )
        # Both sides run the full MSLT chain (ref mslt_prepare.py:274-293:
        # translation AND transcript go through clean_all_transcript)
        transcription = mslt_clean_all([_read_snt(snt)], source_lang)
        translation = (
            mslt_clean_all([_read_snt(translation_files[0])], target_lang)
            if translation_files else None
        )
        translation = translation or ""
        if not transcription:
            continue
        try:
            samples, _ = read_audio(wav, sample_rate=16000)
        except (ValueError, FileNotFoundError):
            continue
        duration = round(len(samples) / 16000.0, 3)
        base_entry = {
            "wav": wav,
            "duration": duration,
            "source_lang": source_lang,
            "transcription": transcription,
            "translation_0": translation or transcription,
            "transcription_and_translation":
                f"{transcription}\n{translation or transcription}",
        }
        entries[f"{uid}-asr"] = dict(
            base_entry, task="transcription", target_lang=source_lang
        )
        if translation:
            entries[f"{uid}-st"] = dict(
                base_entry, task="translation", target_lang=target_lang
            )

    if not entries:
        logger.warning("MSLT: no utterances found under %s", data_folder)
        return None
    out_dir = os.path.join(
        save_folder, f"mslt_{subset}_{source_lang}_{target_lang}"
    )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "data.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(entries, f, indent=2, ensure_ascii=False)
    logger.info("MSLT %s %s->%s: %d entries", subset, source_lang,
                target_lang, len(entries))
    return path
