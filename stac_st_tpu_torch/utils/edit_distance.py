"""Word/token edit distance with alignment backtrace (WER core).

Re-owns the SpeechBrain ErrorRateStats math (reference yaml:311,
``train_multitask.py:285,302``): Levenshtein alignment with insertion /
deletion / substitution counts per utterance. Pure Python/numpy host-side
code (copy of ``stac_st_tpu/utils/edit_distance.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["align_edit_distance", "wer_details"]


def align_edit_distance(
    ref: Sequence[str], hyp: Sequence[str]
) -> Tuple[int, int, int, List[Tuple[str, int, int]]]:
    """Returns (ins, del, sub, alignment ops).

    ops: list of ("=", i, j) | ("S", i, j) | ("I", -1, j) | ("D", i, -1).
    """
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), dtype=np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        sub_cost = (np.array(hyp) != ref[i - 1]).astype(np.int32) if m else None
        for j in range(1, m + 1):
            dist[i, j] = min(
                dist[i - 1, j] + 1,
                dist[i, j - 1] + 1,
                dist[i - 1, j - 1] + int(sub_cost[j - 1]),
            )
    ops: List[Tuple[str, int, int]] = []
    i, j = n, m
    ins = dele = sub = 0
    while i > 0 or j > 0:
        if (
            i > 0
            and j > 0
            and dist[i, j] == dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
        ):
            ops.append(("=" if ref[i - 1] == hyp[j - 1] else "S", i - 1, j - 1))
            sub += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif j > 0 and dist[i, j] == dist[i, j - 1] + 1:
            ops.append(("I", -1, j - 1))
            ins += 1
            j -= 1
        else:
            ops.append(("D", i - 1, -1))
            dele += 1
            i -= 1
    ops.reverse()
    return ins, dele, sub, ops


def wer_details(key: str, ref: Sequence[str], hyp: Sequence[str]) -> Dict:
    ins, dele, sub, ops = align_edit_distance(ref, hyp)
    n_ref = max(len(ref), 1)
    return {
        "key": key,
        "ref_tokens": list(ref),
        "hyp_tokens": list(hyp),
        "insertions": ins,
        "deletions": dele,
        "substitutions": sub,
        "num_ref_tokens": len(ref),
        "num_edits": ins + dele + sub,
        "WER": 100.0 * (ins + dele + sub) / n_ref,
        "alignment": ops,
    }
