"""SentencePiece-faithful BPE merge engine (``bpe_model_trainer.cc`` port;
a copy of ``stac_st_tpu/tokenizer/spm_bpe.py``).

SURVEY §2.2 pins "bit-identical vocab" as the tokenizer-training
requirement (the reference trains with the C++ ``spm_train``,
``stac-st/train_tokenizer.py:23-37``). This module
reproduces the C++ BPE trainer's algorithm — not just "a BPE" — so the
emitted piece ORDER and SCORES match:

* **Selection comparator**: highest pair frequency; ties prefer the
  SHORTER merged string (in unicode chars), then the lexicographically
  smaller one (UTF-8 order == code-point order, which Python ``<``
  preserves).
* **Emission order = model order**: merged pieces are appended to the
  vocab in merge order with score ``-emission_index`` (the first body
  piece scores 0). This is load-bearing: SentencePiece's BPE *encoder*
  picks merges by best score, so scores must rank merges by training
  order for encoding to reproduce training segmentations.
* **Required characters come AFTER the merges**, sorted by (frequency
  desc, code point asc), continuing the score numbering — and the merge
  loop budget is ``vocab_size - meta_pieces - required_chars`` (chars
  are reserved up front, exactly like the C++ trainer).
* **Position-set bookkeeping**: pair symbols are interned by their
  merged STRING; a pair created later via a different split (e.g.
  ``a+bc`` after ``ab+c`` already exists) lands on the same symbol and
  its positions are pruned by the left/right validity check — the same
  quirk the C++ ``symbols_cache_`` fingerprint interning produces.
* **No minimum-frequency cutoff**: merging continues while any valid
  pair occurs at all (frequency >= 1), as in the C++ trainer; the loop
  stops early only when no candidate remains.
* **Active-symbol bookkeeping**: new pairs become selectable the moment
  they are created (C++ ``AddNewPair`` inserts into ``active_symbols_``),
  and every 100 emissions the set is pruned to the top ``max(1000, 5%)``
  candidates by frequency — the C++ trainer's search pruning,
  reproduced so very large corpora behave identically. (The
  C++ boundary tie order comes from hash-map iteration; ours is
  insertion order. The boundary can only matter when >1000 candidates
  tie exactly at the cut frequency AND one of them would later win —
  documented residual risk, certify on-site with
  ``tools/verify_tokenizer.py``.)

Overlapping occurrences ("aaa" contains "aa" twice) are counted per
position and resolved left-to-right at merge time through position
invalidation, again matching the C++ data structures.

**Frequency accounting is exactly incremental** (a real-corpus
performance requirement the selection semantics don't notice): where
the C++ ``ComputeFreq`` rescans a symbol's position set on every
selection-loop visit — pruning stale entries as it goes — this engine
keeps every position set stale-free by construction, so ``freq`` is a
plain counter. Equivalence argument: a merge of ``best`` at
``(sid, l, r)`` invalidates exactly three entries — ``(sid, prev, l)``
of the left-neighbour pair, ``(sid, l, r)`` of ``best`` itself, and
``(sid, r, next)`` of the right-neighbour pair (array slots only ever
grow into a merged symbol or become ``None``) — and all three are
removed eagerly at apply time. Entries that are identity-mismatched at
creation (a different split of an interned string, the C++
``symbols_cache_`` quirk) can never become valid later, so they are
never added. The selection comparator reads the same frequencies the
C++ scan would compute, at O(1) per visit instead of O(positions).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["SpmBpeMergeEngine"]


class _Sym:
    """One trainer symbol: a character or a merged pair (left, right)."""

    __slots__ = ("chars", "left", "right", "positions", "freq", "emitted")

    def __init__(self, chars: str,
                 left: Optional["_Sym"] = None,
                 right: Optional["_Sym"] = None):
        self.chars = chars
        self.left = left
        self.right = right
        # encoded positions (sid, left_index, right_index), kept sorted
        # lazily; invalid entries are ERASED (not skipped) on recount,
        # like the C++ ComputeFreq.
        self.positions: set = set()
        self.freq = 0
        self.emitted = False

    @property
    def is_bigram(self) -> bool:
        return self.left is not None


class SpmBpeMergeEngine:
    """Runs the spm BPE merge loop over (word, frequency) sentences.

    ``sentences``: iterable of (word, freq) where words already carry the
    ``▁`` marker and contain only in-alphabet characters.
    """

    def __init__(self, sentences: Iterable[Tuple[str, int]]):
        self.sentences: List[Tuple[List[Optional[_Sym]], int]] = []
        self.cache: Dict[str, _Sym] = {}  # merged-string -> symbol
        # C++ AddNewPair inserts straight into active_symbols_ — new pairs
        # are selectable immediately; UpdateActiveSymbols prunes every 100
        self.active: Dict[_Sym, None] = {}
        for word, freq in sentences:
            arr: List[Optional[_Sym]] = [
                self._char_symbol(ch) for ch in word
            ]
            self.sentences.append((arr, int(freq)))
        for sid, (arr, _freq) in enumerate(self.sentences):
            for i in range(1, len(arr)):
                self._add_pair(sid, i - 1, i)

    # ------------------------------------------------------------ internals
    def _char_symbol(self, ch: str) -> _Sym:
        sym = self.cache.get(ch)
        if sym is None:
            sym = _Sym(ch)
            self.cache[ch] = sym
        return sym

    def _add_pair(self, sid: int, left: int, right: int) -> None:
        arr = self.sentences[sid][0]
        ls, rs = arr[left], arr[right]
        if ls is None or rs is None:
            return
        merged = ls.chars + rs.chars
        sym = self.cache.get(merged)
        if sym is None:
            sym = _Sym(merged, ls, rs)
            self.cache[merged] = sym
        # interned by string: a different split of the same string lands
        # here too. Identity-mismatched entries can never become valid
        # (slots only grow or become None), so they are not recorded —
        # the C++ equivalent records them and prunes them as stale.
        if ls is sym.left and rs is sym.right:
            sym.positions.add((sid, left, right))
            sym.freq += self.sentences[sid][1]
        if not sym.emitted:
            self.active[sym] = None

    def _drop_pair(self, sid: int, left: int, right: int,
                   ls: _Sym, rs: _Sym) -> None:
        """Eagerly retire the entry a merge just invalidated (``ls``/``rs``
        are the slot values BEFORE the merge overwrote them)."""
        sym = self.cache.get(ls.chars + rs.chars)
        if sym is None:
            return
        pos = (sid, left, right)
        if pos in sym.positions:
            sym.positions.discard(pos)
            sym.freq -= self.sentences[sid][1]

    def _update_active(self) -> None:
        candidates = [
            s for s in self.cache.values() if s.is_bigram and not s.emitted
        ]
        # keep top max(1000, 5%) by freq (C++ kMinActiveSymbolsSize /
        # kTopFrequentRatio); stable sort = insertion-order ties
        size = min(max(1000, int(len(candidates) * 0.05)), len(candidates))
        candidates.sort(key=lambda s: -s.freq)
        self.active = dict.fromkeys(candidates[:size])

    @staticmethod
    def _better(a: _Sym, b: Optional[_Sym]) -> bool:
        """C++ comparator: freq desc, merged length asc, string asc."""
        if b is None:
            return True
        if a.freq != b.freq:
            return a.freq > b.freq
        if len(a.chars) != len(b.chars):
            return len(a.chars) < len(b.chars)
        return a.chars < b.chars

    def _next_index(self, sid: int, i: int) -> int:
        arr = self.sentences[sid][0]
        j = i + 1
        while j < len(arr) and arr[j] is None:
            j += 1
        return j if j < len(arr) else -1

    def _prev_index(self, sid: int, i: int) -> int:
        arr = self.sentences[sid][0]
        j = i - 1
        while j >= 0 and arr[j] is None:
            j -= 1
        return j

    # ------------------------------------------------------------ main loop
    def run(self, n_merges: int) -> List[Tuple[str, int]]:
        """Emit up to ``n_merges`` merged pieces in spm order.

        Returns [(piece, freq_at_emission)] — the caller assigns scores
        by emission index.
        """
        out: List[Tuple[str, int]] = []
        while len(out) < n_merges:
            if len(out) % 100 == 0:
                self._update_active()
            best: Optional[_Sym] = None
            for sym in self.active:
                # freq is exact by construction (see module docstring)
                if sym.freq <= 0 or sym.emitted:
                    continue
                if self._better(sym, best):
                    best = sym
            if best is None:
                break
            out.append((best.chars, best.freq))
            best.emitted = True
            # replace occurrences left-to-right; overlaps invalidate via
            # the None holes (the C++ loop's nullptr guard). Iterate a
            # sorted snapshot: eager retirement mutates the live set.
            for sid, left, right in sorted(best.positions):
                arr = self.sentences[sid][0]
                if arr[left] is not best.left or arr[right] is not best.right:
                    continue
                prev = self._prev_index(sid, left)
                nxt = self._next_index(sid, right)
                # retire the two neighbour entries this merge kills
                if prev >= 0:
                    self._drop_pair(sid, prev, left, arr[prev], best.left)
                if nxt >= 0:
                    self._drop_pair(sid, right, nxt, best.right, arr[nxt])
                arr[left] = best
                arr[right] = None
                if prev >= 0:
                    self._add_pair(sid, prev, left)
                if nxt >= 0:
                    self._add_pair(sid, left, nxt)
            best.positions.clear()
            best.freq = 0
            self.active.pop(best, None)
        return out
