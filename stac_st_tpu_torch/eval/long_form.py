"""Long-form evaluation: hypothesis realignment to reference segmentation.

Port of ``stac_st_tpu/eval/long_form.py`` (host-side numpy).

Re-owns the role of mwerSegmenter in the reference's long-form protocol
(``evaluations/vad_shas/run_align_and_eval.sh:57-70``): decoding
VAD-segmented audio yields one hypothesis stream per conversation whose
segment boundaries don't match the reference utterances; before BLEU/WER the
stream must be re-split against the reference segmentation. (The reference
shells out to the external mwerSegmenter binary — and its
``evaluation/aligner.py`` helper is absent from the repo, SURVEY.md §2.1 —
so this is a from-scratch implementation of the same minimum-WER
segmentation objective.)

Algorithm: dynamic programming over (reference segment, hypothesis word
position) minimizing the total word edit distance when the hypothesis word
stream is split into ``len(references)`` consecutive spans — the classical
mwer segmentation (Matusov et al. 2005).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = ["mwer_segment", "realign_hypotheses"]


def _levenshtein_row(ref: Sequence[str], hyp: Sequence[str]) -> np.ndarray:
    """dist(ref, hyp[:k]) for all k — one DP column sweep."""
    n = len(ref)
    col = np.arange(n + 1, dtype=np.int32)
    out = np.empty(len(hyp) + 1, np.int32)
    out[0] = n  # deleting all of ref
    for k, word in enumerate(hyp, start=1):
        prev = col.copy()
        col[0] = k
        for i in range(1, n + 1):
            col[i] = min(
                prev[i] + 1,
                col[i - 1] + 1,
                prev[i - 1] + (ref[i - 1] != word),
            )
        out[k] = col[n]
    return out


def mwer_segment(
    references: List[List[str]], hyp_words: List[str]
) -> List[List[str]]:
    """Split hyp_words into len(references) spans minimizing total WER."""
    R, H = len(references), len(hyp_words)
    if R == 0:
        return []
    if R == 1:
        return [list(hyp_words)]

    INF = np.iinfo(np.int32).max // 2
    # best[i][j] = min cost of aligning refs[:i] to hyp[:j]
    best = np.full((R + 1, H + 1), INF, np.int32)
    back = np.zeros((R + 1, H + 1), np.int32)
    best[0, 0] = 0
    for i in range(1, R + 1):
        ref = references[i - 1]
        for j in range(H + 1):
            if best[i - 1, j] >= INF:
                continue
            # cost of matching ref to hyp[j:k] for every k ≥ j
            row = _levenshtein_row(ref, hyp_words[j:])
            totals = best[i - 1, j] + row
            better = totals < best[i, j:]
            if np.any(better):
                idx = np.nonzero(better)[0]
                best[i, j + idx] = totals[idx]
                back[i, j + idx] = j
    # backtrace
    cuts = [H]
    j = H
    for i in range(R, 0, -1):
        j = int(back[i, j])
        cuts.append(j)
    cuts.reverse()
    return [hyp_words[cuts[i] : cuts[i + 1]] for i in range(R)]


def realign_hypotheses(
    references: List[str], hypothesis_stream: str
) -> List[str]:
    """Convenience: whitespace-tokenized realignment returning strings."""
    refs = [r.split() for r in references]
    spans = mwer_segment(refs, hypothesis_stream.split())
    return [" ".join(span) for span in spans]
