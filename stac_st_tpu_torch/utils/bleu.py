"""Corpus BLEU as the JAX package computes it through
``sacrebleu.corpus_bleu`` with its defaults, for the port's metrics.

The port keeps its own copy because the card's environment has no
``sacrebleu``. The defaults it reproduces: the ``13a`` tokenizer (mteval
v13a's: ``<skipped>`` and line breaks removed, four XML entities
unescaped, punctuation and symbols split off, periods and commas split
unless next to a digit, a dash split after a digit), case kept, n-grams up
to 4 clipped by their largest count in any one reference, the reference
length closest to the hypothesis length (the shorter on a tie), the
brevity penalty exp(1 − ref/sys), and ``exp`` smoothing (the k-th order
without a match counts as 1 / 2^k of a match). A segment's reference may
be None (a variable number of references).
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["BleuScore", "corpus_bleu", "tokenize_13a"]

MAX_ORDER = 4

_13A = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


class BleuScore(NamedTuple):
    score: float
    counts: List[int]
    totals: List[int]
    precisions: List[float]
    bp: float
    sys_len: int
    ref_len: int


def tokenize_13a(line: str) -> str:
    line = line.replace("<skipped>", "").replace("-\n", "").replace("\n",
                                                                    " ")
    if "&" in line:
        for entity, char in (("&quot;", '"'), ("&amp;", "&"), ("&lt;", "<"),
                             ("&gt;", ">")):
            line = line.replace(entity, char)
    line = f" {line} "
    for pattern, repl in _13A:
        line = pattern.sub(repl, line)
    return " ".join(line.split())


def _ngrams(line: str) -> Tuple[Counter, int]:
    tokens = line.split()
    grams = Counter(tuple(tokens[i:i + n])
                    for n in range(1, MAX_ORDER + 1)
                    for i in range(len(tokens) - n + 1))
    return grams, len(tokens)


def _closest(hyp_len: int, ref_lens: Sequence[int]) -> int:
    best_diff, best = -1, -1
    for ref_len in ref_lens:
        diff = abs(hyp_len - ref_len)
        if best_diff == -1 or diff < best_diff:
            best_diff, best = diff, ref_len
        elif diff == best_diff and ref_len < best:
            best = ref_len
    return best


def corpus_bleu(hypotheses: Sequence[str],
                references: Sequence[Sequence[Optional[str]]]) -> BleuScore:
    """hypotheses: [segment]; references: [stream][segment]."""
    sys_len = ref_len = 0
    correct, total = [0] * MAX_ORDER, [0] * MAX_ORDER
    for hyp, refs in zip(hypotheses, zip(*references)):
        ref_grams: Optional[Counter] = None
        ref_lens = []
        for ref in refs:
            if ref is None:
                continue
            grams, n = _ngrams(tokenize_13a(ref.rstrip()))
            ref_lens.append(n)
            if ref_grams is None:
                ref_grams = grams
            else:
                for gram, count in grams.items():
                    ref_grams[gram] = max(ref_grams[gram], count)
        grams, hyp_len = _ngrams(tokenize_13a(hyp.rstrip()))
        sys_len += hyp_len
        ref_len += _closest(hyp_len, ref_lens)
        for gram, count in grams.items():
            total[len(gram) - 1] += count
            if gram in ref_grams:
                correct[len(gram) - 1] += min(count, ref_grams[gram])

    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_ORDER
    if not any(correct):
        return BleuScore(0.0, correct, total, precisions, bp, sys_len,
                         ref_len)
    smooth = 1.0
    for n in range(MAX_ORDER):
        if total[n] == 0:
            break
        if correct[n] == 0:
            smooth *= 2
            precisions[n] = 100.0 / (smooth * total[n])
        else:
            precisions[n] = 100.0 * correct[n] / total[n]
    log_sum = sum(math.log(p) if p != 0.0 else -9999999999
                  for p in precisions)
    score = bp * math.exp(log_sum / MAX_ORDER)
    return BleuScore(score, correct, total, precisions, bp, sys_len, ref_len)
