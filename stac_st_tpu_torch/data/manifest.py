"""JSON manifest loading (the frozen dataset contract; a copy of
``stac_st_tpu/data/manifest.py``).

The reference's corpus preparation emits JSON manifests of the form
(reference ``README.md:101-112`` + multi-turn extensions,
``fisher_callhome_prepare_turns.py:250-296``)::

    {"utt_id": {"wav": "{data_root}/a.wav [{data_root}/b.wav ...]",
                "duration": 12.3, "task": "translation",
                "source_lang": "es", "target_lang": "en",
                "transcription": "...", "translation_0": "...",
                ["translation_1..3", "transcription_and_translation",
                 "segments_start", "segments_duration", "segments_channel",
                 "nb_turns"]}, ...}

This module loads that format byte-compatibly: ``{data_root}`` replacement
(``dataio_and_utils.py:92-171``), multi-wav space-separated fields
(``train_multitask.py:493-497``), and split-name derivation
``"_".join(path.split("/")[-2:])`` (``train_multitask.py:701``).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

__all__ = ["load_manifest", "split_name", "ManifestEntry",
           "parse_segments_field"]

ManifestEntry = Dict[str, Any]


def parse_segments_field(value, cast=float) -> List:
    """``segments_*`` fields are space-joined strings in the reference
    manifests (``fisher_callhome_prepare_turns.py:255-257``); accept the
    string form, a single scalar (resegmented manifests store
    ``segments_start: 0``), or a list."""
    if value is None:
        return []
    if isinstance(value, str):
        return [cast(v) for v in value.split(" ") if v != ""]
    if isinstance(value, (int, float)):
        return [cast(value)]
    return [cast(v) for v in value]


def load_manifest(
    json_path: str, replacements: Optional[Dict[str, str]] = None
) -> Dict[str, ManifestEntry]:
    with open(json_path) as f:
        data = json.load(f)
    if replacements:
        for entry in data.values():
            wav = entry.get("wav")
            if isinstance(wav, str):
                for key, value in replacements.items():
                    wav = wav.replace("{" + key + "}", value)
                entry["wav"] = wav
    return data


def wav_paths(entry: ManifestEntry) -> List[str]:
    """The wav field may hold several space-separated files to concatenate
    (multi-turn samples — ``train_multitask.py:493-497``)."""
    return entry["wav"].replace("  ", " ").split()


def split_name(dataset_path: str) -> str:
    """'fisher-callhome/dev-30s/data-turns-st' -> 'dev-30s_data-turns-st'."""
    return "_".join(dataset_path.split("/")[-2:])
