"""CoVoST2 preparation: inject translations into CommonVoice manifests.

A port of ``stac_st_tpu/prep/covost.py`` (byte-equal manifests). It
re-owns ``datasets/covost2`` (reference ``convert_covost_splits_to_json.py``
+ ``get_covost_splits.py``): the CoVoST2 release ships per-pair TSVs
(``covost_v2.<src>_<tgt>.tsv`` with columns path / translation / split)
keyed by CommonVoice clip names. For each TSV row, look up the prepared CV
manifest entry (bare clip key — the reference schema), run the full CoVoST
translation cleaning chain (``:372-427``: normalize → MSLT-profile
transcription clean incl. the ``N → n`` fold → Moses normalize →
de-punctuate → Moses tokenize → accent handling → ≥3-words gate), and flip
the entry to ``task: translation`` with the cleaned text as
``translation_0`` — exactly the reference's in-place update (``:428-436``).

Deviation (deliberate): the reference's missing-key handler lacks a
``continue`` and reuses the previous iteration's entry (or crashes on the
first miss); missing clips are skipped and counted here.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

from .cleaning import covost_clean_all

logger = logging.getLogger(__name__)

__all__ = ["prepare_covost"]


def _read_covost_tsv(path: str) -> Dict[str, Dict[str, str]]:
    """clip id (no .mp3) -> {translation, split} (reference ``:374-381``:
    plain tab split, header row skipped by its 'path' marker)."""
    out: Dict[str, Dict[str, str]] = {}
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.strip().split("\t")
            if not line or line[0] == "path":
                continue
            utt_id = line[0].split(".mp3")[0]
            out[utt_id] = {
                "translation": line[2] if len(line) > 2 else "",
                "split": line[3] if len(line) > 3 else "",
            }
    return out


def prepare_covost(
    covost_tsv: str,
    cv_manifest: str,
    save_folder: str,
    source_lang: str,
    target_lang: str,
    keep_accents: bool = True,
) -> Dict[str, str]:
    """Join one CoVoST pair TSV with a prepared CV manifest → ST manifests
    (one JSON per TSV split; a pre-split TSV yields a single file)."""
    pairs = _read_covost_tsv(covost_tsv)
    with open(cv_manifest) as f:
        cv_data = json.load(f)

    by_split: Dict[str, Dict[str, Dict]] = {}
    missing = 0
    for utt_id, info in pairs.items():
        entry: Optional[Dict] = cv_data.get(utt_id)
        if entry is None and f"{utt_id}-asr" in cv_data:
            entry = cv_data[f"{utt_id}-asr"]  # legacy suffixed manifests
        if entry is None:
            missing += 1
            continue
        words = covost_clean_all(
            info["translation"], target_lang, accented_letters=keep_accents
        )
        if words is None:
            continue
        st_entry = dict(entry)
        st_entry["task"] = "translation"
        st_entry["source_lang"] = source_lang
        st_entry["target_lang"] = target_lang
        st_entry["translation_0"] = words
        split = info["split"] or "train"
        by_split.setdefault(split, {})[utt_id] = st_entry

    pair = f"{source_lang}_{target_lang}"
    out_dir = os.path.join(save_folder, f"covost_{pair}")
    os.makedirs(out_dir, exist_ok=True)
    outputs = {}
    for split, entries in by_split.items():
        path = os.path.join(out_dir, f"{split}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=2, ensure_ascii=False)
        outputs[split] = path
        logger.info("covost %s/%s: %d utterances", pair, split, len(entries))
    if missing:
        logger.info("covost %s: %d TSV clips missing from the CV manifest",
                    pair, missing)
    return outputs
