"""Utterance records and JSON manifest emission (the frozen dataset schema;
port of ``stac_st_tpu/prep/records.py``, byte-equal manifests).

Emits the manifest format the reference's preps produce
(``fisher_callhome_prepare.py:205-267``, turns variant ``:250-296`` of the
_turns script): one ``-asr`` and one ``-st`` JSON per split, entries keyed
``{uid}-asr`` / ``{uid}-st`` with wav path(s), duration, task,
source/target_lang, transcription, translation_0..3,
``transcription_and_translation`` (train), and — for multi-turn data —
``segments_start`` / ``segments_duration`` / ``segments_channel`` /
``nb_turns`` metadata consumed by the RTTM evaluation chain.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["Utterance", "write_manifests"]


@dataclass
class Utterance:
    uid: str                       # e.g. "20051019_..._fsp-0-000123-000456"
    wav: str                       # output wav path (or "{data_root}/...")
    duration: float                # seconds
    transcription: str
    translations: List[str] = field(default_factory=list)
    source_lang: str = "es"
    target_lang: str = "en"
    # source-audio bookkeeping (pre-segmentation)
    source_audio: Optional[str] = None   # sph/wav to cut from
    channel: int = 0
    start: int = 0                 # centiseconds in source audio
    end: int = 0
    # multi-turn metadata
    turn_start: List[float] = field(default_factory=list)
    turn_duration: List[float] = field(default_factory=list)
    turn_channel: List[int] = field(default_factory=list)

    @property
    def nb_turns(self) -> int:
        return self.transcription.count("[turn]")

    @property
    def recording_id(self) -> str:
        return self.uid.split("-")[0]


def _entry(utt: Utterance, task: str, n_refs: int,
           with_joint: bool, with_segments: bool) -> Dict:
    is_st = task == "translation"
    entry: Dict = {
        "wav": utt.wav,
        "source_lang": utt.source_lang,
        "target_lang": utt.target_lang if is_st else utt.source_lang,
    }
    if with_segments:
        # reference turns schema (fisher_callhome_prepare_turns.py:250-296):
        # nb_turns + space-joined string fields, BEFORE duration — key order
        # is part of the byte-frozen manifest contract
        entry["nb_turns"] = utt.nb_turns
        entry["segments_start"] = " ".join(str(i) for i in utt.turn_start)
        entry["segments_duration"] = " ".join(
            str(i) for i in utt.turn_duration
        )
        entry["segments_channel"] = " ".join(
            str(i) for i in utt.turn_channel
        )
    entry.update({
        "duration": utt.duration,
        "task": task,
        "transcription": utt.transcription,
    })
    if n_refs > 1 and is_st:
        for i in range(n_refs):
            entry[f"translation_{i}"] = (
                utt.translations[i] if i < len(utt.translations) else ""
            )
    else:
        entry["translation_0"] = (
            utt.translations[0] if utt.translations else utt.transcription
        )
    if with_joint:
        ref = entry.get("translation_0", "")
        entry["transcription_and_translation"] = f"{utt.transcription}\n{ref}"
    return entry


def write_manifests(
    utterances: List[Utterance],
    out_dir: str,
    save_suffix: str = "data",
    n_refs: int = 1,
    with_joint: Optional[bool] = None,
    with_segments: bool = False,
) -> Dict[str, str]:
    """Write ``{suffix}-asr.json`` and ``{suffix}-st.json``.

    n_refs > 1 marks eval splits carrying 4 translations (fisher
    dev/dev2/test); with_joint defaults to the reference behavior
    (joint field on 1-ref data, used for tokenizer training).
    """
    if with_joint is None:
        with_joint = n_refs == 1
    os.makedirs(out_dir, exist_ok=True)
    asr: Dict[str, Dict] = {}
    st: Dict[str, Dict] = {}
    for utt in utterances:
        asr[f"{utt.uid}-asr"] = _entry(
            utt, "transcription", 1, True, with_segments
        )
        st[f"{utt.uid}-st"] = _entry(
            utt, "translation", n_refs, with_joint, with_segments
        )
    paths = {}
    for name, data in (("asr", asr), ("st", st)):
        path = os.path.join(out_dir, f"{save_suffix}-{name}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)
        paths[name] = path
    return paths
