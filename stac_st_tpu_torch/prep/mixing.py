"""Cross-dataset mixers: synthetic multi-turn concatenation and JSON unions.

A port of ``stac_st_tpu/prep/mixing.py`` whose manifests are byte-equal to
the JAX package's for the same inputs and seed. It re-owns the reference's
``datasets/cross_datasets_experiments``:

* :func:`concat_json` (reference ``concat_json.py:73-152``) — randomly draw
  manifest entries and concatenate them into synthetic ≤ ``max_seconds``
  multi-turn samples: wav fields joined space-separated (the dataloader
  concatenates the audio — ``train_multitask.py:493-497``), texts joined
  with `` [turn] ``, and ``segments_*`` metadata accumulated;
* :func:`join_json` (reference ``join_json.py:12-40``) — dict-union of N
  manifests, adding the ``transcription_and_translation`` field used for
  tokenizer training.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional

__all__ = ["concat_json", "join_json"]


def join_json(json_paths: List[str], out_path: str) -> Dict:
    """Union of manifests + joint transcription/translation field."""
    merged: Dict[str, Dict] = {}
    for path in json_paths:
        with open(path) as f:
            data = json.load(f)
        for uid, entry in data.items():
            entry = dict(entry)
            if "transcription_and_translation" not in entry:
                entry["transcription_and_translation"] = (
                    f"{entry.get('transcription', '')}\n"
                    f"{entry.get('translation_0', '')}"
                )
            merged[uid] = entry
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=2, ensure_ascii=False)
    return merged


def concat_json(
    json_path: str,
    out_path: str,
    max_seconds: float = 30.0,
    seed: int = 8886,
    max_samples: Optional[int] = None,
) -> Dict:
    """Synthetic multi-turn mixing of single-utterance manifests."""
    with open(json_path) as f:
        data = json.load(f)
    rng = random.Random(seed)
    pool = list(data.items())
    rng.shuffle(pool)

    merged: Dict[str, Dict] = {}
    i = 0
    while i < len(pool):
        uid, entry = pool[i]
        group = [(uid, entry)]
        total = float(entry.get("duration", 0.0))
        i += 1
        while i < len(pool):
            nuid, nentry = pool[i]
            ndur = float(nentry.get("duration", 0.0))
            if total + ndur > max_seconds:
                break
            if nentry.get("task") != entry.get("task") or (
                nentry.get("target_lang") != entry.get("target_lang")
            ):
                break
            group.append((nuid, nentry))
            total += ndur
            i += 1

        base = group[0][1]
        new_uid = group[0][0] if len(group) == 1 else (
            group[0][0] + "+" + str(len(group))
        )
        starts, durations, channels = [], [], []
        offset = 0.0
        for _, e in group:
            starts.append(round(offset, 3))
            durations.append(float(e.get("duration", 0.0)))
            channels.append(0)
            offset += float(e.get("duration", 0.0))
        new_entry = {
            "wav": " ".join(e["wav"] for _, e in group),
            "duration": round(total, 3),
            "task": base.get("task", ""),
            "source_lang": base.get("source_lang", ""),
            "target_lang": base.get("target_lang", ""),
            "transcription": " [turn] ".join(
                e.get("transcription", "") for _, e in group
            ),
            "translation_0": " [turn] ".join(
                e.get("translation_0", "") for _, e in group
            ),
            "segments_start": " ".join(str(s) for s in starts),
            "segments_duration": " ".join(str(d) for d in durations),
            "segments_channel": " ".join(str(c) for c in channels),
            "nb_turns": len(group) - 1,
        }
        new_entry["transcription_and_translation"] = (
            f"{new_entry['transcription']}\n{new_entry['translation_0']}"
        )
        merged[new_uid] = new_entry
        if max_samples is not None and len(merged) >= max_samples:
            break

    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=2, ensure_ascii=False)
    return merged
