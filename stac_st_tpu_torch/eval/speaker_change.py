"""Speaker-change detection metrics: P/R/F1/Miss/FA over tolerance windows
(port of ``stac_st_tpu/eval/speaker_change.py``, results exactly equal).

Re-owns the reference scorer (``evaluations/vad_shas/get_f1_score.py``):

* :func:`evaluate_speaker_turn_detection` is the exact-semantics port of the
  script-invoked path (``evaluate_speaker_turn_detection_davidhzc``,
  ``get_f1_score.py:505-645``, called by ``eval_speaker_change.sh:55-67``):
  hyp same-speaker runs merge into segments (the reference drops the first
  RTTM row before aggregation — reproduced), turn REGIONS form between
  consecutive segments, GT regions widen by the tolerance and merge when
  overlapping (row-wise, as the pandas shift/cumsum does), and a predicted
  region counts as correct when it overlaps any merged GT region under
  pandas' mixed-closure rule — hyp ``(s, e]`` vs GT ``[a, b]`` overlap iff
  ``s < b and a <= e``. Precision = correct predictions / all predictions;
  Recall = detected GT regions / all GT regions; F1 harmonic of the two;
  Miss = 1 − R; FA = incorrect predictions / all predictions. Oracle-tested
  against the reference's own module (tests/test_speaker_change_oracle.py).
* :func:`score_change_points` / :func:`evaluate_speaker_change` are a
  simpler point-event API (greedy nearest-first within ±tolerance) kept for
  manifest-level smoke checks.

Standard tolerance grid: {0.1, 0.2, 0.25, 0.5, 0.8, 1.0} s.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

__all__ = ["ChangePointMetrics", "score_change_points",
           "evaluate_speaker_change", "evaluate_speaker_turn_detection",
           "TOLERANCE_GRID",
           "gt_changes_from_manifest", "hyp_changes_from_rttm"]

TOLERANCE_GRID = (0.1, 0.2, 0.25, 0.5, 0.8, 1.0)


# ---------------------------------------------------------------------------
# Exact reference semantics (get_f1_score.py:505-645)
# ---------------------------------------------------------------------------

def _read_rttm_rows(path: str) -> List[tuple]:
    """Reference read_rttm (:54-66): space-split; (name, start, dur, spk)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            rows.append(
                (parts[1], float(parts[3]), float(parts[4]), parts[7])
            )
    return rows


def _turn_regions(segments: List[tuple]) -> List[tuple]:
    """Regions between consecutive segments: sorted (end_i, start_{i+1}),
    rounded to 3 decimals (pandas .round(3) == Python banker's round)."""
    out = []
    for i in range(len(segments) - 1):
        ts = round(segments[i][1], 3)
        te = round(segments[i + 1][0], 3)
        out.append((min(ts, te), max(ts, te), ts, te))
    return out


def evaluate_speaker_turn_detection(
    ref_rttm_path: str,
    hyp_rttm_path: str,
    tolerances: Sequence[float] = TOLERANCE_GRID,
    merge_overlap_gt_regions: bool = True,
    mean_turn_point: bool = False,
) -> List[Dict[str, float]]:
    """Exact port of the reference's region-merge speaker-turn scorer.

    Returns one dict per tolerance with precision / recall / f1 / miss / fa
    (percentages) plus the region counts the reference prints.
    """
    ref_rows = _read_rttm_rows(ref_rttm_path)
    hyp_rows = _read_rttm_rows(hyp_rttm_path)
    ref_segs = [(s, s + d) for _, s, d, _ in ref_rows]

    labels = [spk for _, _, _, spk in hyp_rows]
    if len(set(labels)) > 1:
        # group consecutive same-speaker rows (first row opens group 1);
        # the reference aggregates over df.iloc[1:] — row 0 is dropped
        gids, g, prev = [], 0, None
        for lab in labels:
            if lab != prev:
                g += 1
            gids.append(g)
            prev = lab
        agg: Dict[int, tuple] = {}
        for (_, s, d, _), gid in list(zip(hyp_rows, gids))[1:]:
            lo, hi = agg.get(gid, (float("inf"), float("-inf")))
            agg[gid] = (min(lo, s), max(hi, s + d))
        merged = [agg[k] for k in sorted(agg)]
        regions = _turn_regions([(lo, hi) for lo, hi in merged])
        if mean_turn_point:
            hyp_regions = [((ts + te) / 2, (ts + te) / 2)
                           for _, _, ts, te in regions]
        else:
            hyp_regions = [(lo, hi) for lo, hi, _, _ in regions]
    else:
        hyp_regions = [(s, e) for s, e in
                       [(s, s + d) for _, s, d, _ in hyp_rows]]

    ref_regions = [(lo, hi) for lo, hi, _, _ in _turn_regions(ref_segs)]
    num_pred = len(hyp_regions)

    results = []
    for tolerance in tolerances:
        widened = [(lo - tolerance, hi + tolerance) for lo, hi in ref_regions]
        if merge_overlap_gt_regions:
            # new group when this row's start > PREVIOUS ROW's end
            # (pandas shift/cumsum — row-wise, not running max)
            gt_agg: Dict[int, tuple] = {}
            g, prev_end = 0, None
            for lo, hi in widened:
                if prev_end is not None and lo > prev_end:
                    g += 1
                a, b = gt_agg.get(g, (float("inf"), float("-inf")))
                gt_agg[g] = (min(a, lo), max(b, hi))
                prev_end = hi
            gt = [gt_agg[k] for k in sorted(gt_agg)]
        else:
            gt = list(widened)

        tp = fp = 0
        detected: set = set()
        for s, e in hyp_regions:
            hits = [i for i, (a, b) in enumerate(gt) if s < b and a <= e]
            detected.update(hits)
            if hits:
                tp += 1
            else:
                fp += 1
        num_gt = len(gt)
        recall = len(detected) / num_gt * 100
        precision = tp / num_pred * 100
        f1 = 2 / (1 / precision + 1 / recall)
        results.append({
            "tolerance": tolerance,
            "precision": precision,
            "recall": recall,
            "f1": f1,
            "miss": (num_gt - len(detected)) / num_gt * 100,
            "fa": fp / num_pred * 100,
            "num_gt_regions": num_gt,
            "num_pred_regions": num_pred,
            "num_gt_change_points_unmerged": len(ref_segs) - 1,
        })
    return results


@dataclass
class ChangePointMetrics:
    tolerance: float
    true_positives: int
    false_positives: int
    false_negatives: int

    @property
    def precision(self) -> float:
        denom = self.true_positives + self.false_positives
        return self.true_positives / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.true_positives + self.false_negatives
        return self.true_positives / denom if denom else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def mdr(self) -> float:
        return 1.0 - self.recall

    @property
    def far(self) -> float:
        return 1.0 - self.precision

    def as_dict(self) -> Dict[str, float]:
        return {
            "tolerance": self.tolerance,
            "precision": self.precision,
            "recall": self.recall,
            "f1": self.f1,
            "MDR": self.mdr,
            "FAR": self.far,
            "TP": self.true_positives,
            "FP": self.false_positives,
            "FN": self.false_negatives,
        }


def _merge_close(events: Sequence[float], min_gap: float = 0.0) -> List[float]:
    """Collapse change events closer than min_gap (GT region merging)."""
    out: List[float] = []
    for t in sorted(events):
        if out and t - out[-1] < min_gap:
            continue
        out.append(t)
    return out


def score_change_points(
    reference: Sequence[float],
    hypothesis: Sequence[float],
    tolerance: float,
) -> ChangePointMetrics:
    """Greedy nearest-first matching within ±tolerance seconds."""
    ref = sorted(reference)
    hyp = sorted(hypothesis)
    matched_ref = [False] * len(ref)
    tp = 0
    for h in hyp:
        best_idx, best_dist = -1, tolerance + 1e-9
        for i, r in enumerate(ref):
            if matched_ref[i]:
                continue
            d = abs(h - r)
            if d <= tolerance and d < best_dist:
                best_idx, best_dist = i, d
        if best_idx >= 0:
            matched_ref[best_idx] = True
            tp += 1
    fp = len(hyp) - tp
    fn = len(ref) - tp
    return ChangePointMetrics(tolerance, tp, fp, fn)


def gt_changes_from_manifest(manifest_path: str) -> Dict[str, List[float]]:
    """Per-utterance GT change times (seconds within the utterance clock),
    from the multi-turn segments metadata — a change occurs at the start of
    every segment after the first whose channel differs from the previous."""
    from ..data.manifest import parse_segments_field

    with open(manifest_path) as f:
        data = json.load(f)
    out: Dict[str, List[float]] = {}
    for uid, entry in data.items():
        starts = parse_segments_field(entry.get("segments_start"))
        channels = parse_segments_field(entry.get("segments_channel"), int)
        changes = [
            float(starts[i])
            for i in range(1, len(starts))
            if i >= len(channels) or channels[i] != channels[i - 1]
        ]
        out[uid] = changes
    return out


def hyp_changes_from_rttm(
    rttm_path: str, relative_to_utt: bool = True, merge_gap: float = 0.2
) -> Dict[str, List[float]]:
    """Parse model RTTM (``SPEAKER <utt> 1 <start> <dur> ...``) into
    per-utterance change times; consecutive frame spikes closer than
    merge_gap collapse into one event."""
    raw: Dict[str, List[float]] = {}
    with open(rttm_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5 or parts[0] != "SPEAKER":
                continue
            utt_id = parts[1]
            start = float(parts[3])
            if relative_to_utt:
                try:
                    start -= int(utt_id.split("-")[2]) / 100.0
                except (IndexError, ValueError):
                    pass
            raw.setdefault(utt_id, []).append(start)
    return {uid: _merge_close(ts, merge_gap) for uid, ts in raw.items()}


def evaluate_speaker_change(
    reference: Dict[str, List[float]],
    hypothesis: Dict[str, List[float]],
    tolerances: Iterable[float] = TOLERANCE_GRID,
) -> List[ChangePointMetrics]:
    """Corpus-level metrics at each tolerance (events pooled per utterance)."""
    results = []
    for tol in tolerances:
        tp = fp = fn = 0
        for uid in set(reference) | set(hypothesis):
            m = score_change_points(
                reference.get(uid, []), hypothesis.get(uid, []), tol
            )
            tp += m.true_positives
            fp += m.false_positives
            fn += m.false_negatives
        results.append(ChangePointMetrics(tol, tp, fp, fn))
    return results
