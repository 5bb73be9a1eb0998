"""Aligned ref/hyp RTTM construction for long-form scoring (port of
``stac_st_tpu/eval/rttm_fix.py``, output byte-equal).

Re-owns ``evaluations/vad_shas/fix_RTTM.py`` (and the pyannote variant): the
model emits RTTM events on each utterance's absolute clock (utterance ids
encode centisecond offsets, ``uid-ch-start-end``); the ground truth lives in
the manifest's ``segments_*`` fields. Both are replayed onto one common
timeline with a fixed inter-utterance spacer (5 s in the reference) so
downstream tolerance scoring sees consistent clocks.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from ..data.manifest import parse_segments_field

__all__ = ["build_aligned_rttm", "write_rttm", "fix_rttm"]

SPACER_SECONDS = 5.0


def _utt_bounds(uid: str) -> Tuple[float, float]:
    parts = uid.split("-")
    try:
        return int(parts[2]) / 100.0, int(parts[3].split("-")[0]) / 100.0
    except (IndexError, ValueError):
        return 0.0, 0.0


def build_aligned_rttm(
    manifest_path: str,
    hyp_events: Dict[str, List[float]],
    spacer: float = SPACER_SECONDS,
) -> Tuple[List[str], List[str]]:
    """Returns (ref_lines, hyp_lines) on the common spaced timeline.

    hyp_events: per-utterance change times relative to the utterance start
    (see :func:`..eval.speaker_change.hyp_changes_from_rttm`).
    """
    with open(manifest_path) as f:
        data = json.load(f)

    ref_lines: List[str] = []
    hyp_lines: List[str] = []
    offset = 0.0
    for uid in sorted(data):
        entry = data[uid]
        duration = float(entry.get("duration", 0.0))
        starts = parse_segments_field(entry.get("segments_start"))
        durations = parse_segments_field(entry.get("segments_duration"))
        channels = parse_segments_field(entry.get("segments_channel"), int)
        for i, start in enumerate(starts):
            dur = durations[i] if i < len(durations) else 0.1
            spk = f"SPK{channels[i] if i < len(channels) else 0}"
            ref_lines.append(
                f"SPEAKER {uid} 1 {offset + float(start):.3f} {dur:.3f} "
                f"<NA> <NA> {spk} <NA> <NA>"
            )
        for t in hyp_events.get(uid, []):
            hyp_lines.append(
                f"SPEAKER {uid} 1 {offset + float(t):.3f} 0.040 "
                f"<NA> <NA> SPK1 <NA> <NA>"
            )
        offset += duration + spacer
    return ref_lines, hyp_lines


def write_rttm(lines: List[str], path: str) -> None:
    with open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")


def fix_rttm(
    gt_json: str,
    pred_rttm: str,
    output_folder: str,
    relative_from_uid: bool = True,
) -> Tuple[str, str]:
    """Exact port of the reference RTTM fixer
    (``evaluations/vad_shas/fix_RTTM.py:37-120``; pass
    ``relative_from_uid=False`` for the pyannote variant, whose predictions
    are already on the utterance clock): model CSV + turns manifest → one
    common spaced timeline, ``{file_id}.ref.rttm`` / ``{file_id}.hyp.rttm``
    byte-identical to the reference outputs (tests/test_rttm_fix_oracle.py).
    """
    import csv
    import os

    with open(gt_json) as f:
        gt_data_raw = json.load(f)

    pred_data_raw: Dict[str, List[List]] = {}
    with open(pred_rttm) as f:
        for row in csv.reader(f):
            line = row[0].strip().split()
            rec_id = line[1].replace("-st", "").replace("-asr", "")
            time, dur = line[3], line[4]
            speaker_id = line[7]
            if relative_from_uid:
                start_time = int(line[1].split("-")[2]) / 100
                abs_time = float(time) - start_time
                abs_time = abs_time if abs_time > 0 else 0
                time = f"{abs_time:.4f}"
            pred_data_raw.setdefault(rec_id, []).append(
                [time, dur, speaker_id]
            )

    trailing_time = 0
    ref_rttm: List[str] = []
    hyp_rttm: List[str] = []
    n_errors = 0
    for key in gt_data_raw:
        sample = gt_data_raw[key]
        sample_start = [
            float(i) for i in str(sample["segments_start"]).split(" ")
        ]
        sample_duration = [
            float(i) for i in str(sample["segments_duration"]).split(" ")
        ]
        utt_id = sample["wav"].split("/")[-1].replace(".wav", "")
        if utt_id not in pred_data_raw:
            n_errors += 1
            continue
        for start, duration in zip(sample_start, sample_duration):
            start = trailing_time + start
            ref_rttm.append(
                f"SPEAKER {utt_id} 1 {start:.2f} {duration} "
                f"<NA> <NA> SPK1 <NA> <NA>"
            )
        for start, duration, speaker_id in pred_data_raw[utt_id]:
            start, duration = float(start), float(duration)
            start = trailing_time + start
            hyp_rttm.append(
                f"SPEAKER {utt_id} 1 {start:.2f} {duration} "
                f"<NA> <NA> {speaker_id} <NA> <NA>"
            )
        end_gt = trailing_time + float(sample["duration"])
        trailing_time = int(end_gt + 5)

    file_id = pred_rttm.split("/")[-1].split(".csv")[0]
    ref_path = os.path.join(output_folder, f"{file_id}.ref.rttm")
    hyp_path = os.path.join(output_folder, f"{file_id}.hyp.rttm")
    write_rttm(ref_rttm, ref_path)
    write_rttm(hyp_rttm, hyp_path)
    return ref_path, hyp_path
