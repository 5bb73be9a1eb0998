"""SentencePiece-compatible BPE encoding/decoding (port of
``stac_st_tpu/tokenizer/bpe.py``, pure Python).

Replicates the inference-time behavior the reference relies on
(``stac-st/dataio_and_utils.py:40-67``, ``:234-245``):

* NFKC + whitespace normalization, ``▁`` space escaping, dummy prefix;
* user-defined symbols (``[es]``, ``[en]``, ``[turn]``, ``[xt]``, ...)
  matched as whole units before BPE;
* greedy highest-score pair merging (SentencePiece bpe_model semantics:
  best score first, ties broken by leftmost position);
* unknown characters map to ``<unk>`` (id 0 in the reference contract),
  decoded with the standard `` ⁇ `` unk surface.

The merge loop runs in the port's native library (``native.py``,
``csrc/stacnative.cpp``), as the JAX package runs it in its C++ extension
when that is built; ``BpeEncoder._bpe_segment_plain`` is the pure Python
version, which only the tests call (the ids are identical).
"""

from __future__ import annotations

import heapq
import unicodedata
from typing import Dict, List, Optional, Tuple

from ..native import BpeVocab
from .spm_model import (
    PIECE_CONTROL,
    PIECE_UNKNOWN,
    PIECE_USER_DEFINED,
    SpmModel,
)

__all__ = ["BpeEncoder", "normalize_text", "SPACE"]

SPACE = "▁"  # ▁
UNK_SURFACE = " ⁇ "  # " ⁇ "

# SentencePiece's default normalizer is "nmt_nfkc": the Unicode NFKC
# charsmap plus NMT-specific overrides (reference semantics:
# sentencepiece BuildNmtNFKCMap). The overrides, applied
# per code point BEFORE NFKC (no NFKC mapping produces any of these
# code points, so pre/post application is equivalent to spm's single
# combined longest-match map):
#   * control characters are REMOVED,
#   * assorted separators/markers fold to ASCII space — including
#     U+2581 LOWER ONE EIGHTH BLOCK, which is why raw text can never
#     collide with the ▁ space marker,
#   * U+FF5E FULLWIDTH TILDE keeps its identity (spm erases the
#     NFKC FF5E→007E rule: full/half-width tildes differ in Japanese).
_NMT_REMOVE = frozenset(
    list(range(0x0001, 0x0009))      # C0 controls below TAB
    + [0x000B]                       # VERTICAL TAB
    + list(range(0x000E, 0x0020))    # SO..US (incl. FS/GS/RS/US)
    + [0x007F, 0x008F, 0x009F]       # DEL + two C1 controls
)
_NMT_TO_SPACE = frozenset(
    [0x0009, 0x000A, 0x000C, 0x000D,  # TAB LF FF CR
     0x1680,                          # OGHAM SPACE MARK
     0x2028, 0x2029,                  # LINE / PARAGRAPH SEPARATOR
     0x2581,                          # LOWER ONE EIGHTH BLOCK (the marker)
     0xFEFF, 0xFFFD]                  # BOM, REPLACEMENT CHARACTER
    + list(range(0x200B, 0x2010))     # ZWSP ZWNJ ZWJ LRM RLM
)
_FULLWIDTH_TILDE = 0xFF5E


def _nmt_nfkc(text: str) -> str:
    """The nmt_nfkc charsmap: NMT overrides + NFKC, FF5E preserved.

    FF5E is kept verbatim by normalizing the runs between occurrences
    (exact: FF5E is not a composition base, so splitting cannot change
    any neighbouring NFKC result).
    """
    parts: List[str] = []
    buf: List[str] = []
    for ch in text:
        cp = ord(ch)
        if cp in _NMT_REMOVE:
            continue
        if cp in _NMT_TO_SPACE:
            buf.append(" ")
        elif cp == _FULLWIDTH_TILDE:
            parts.append(unicodedata.normalize("NFKC", "".join(buf)))
            buf = []
            parts.append("～")
        else:
            buf.append(ch)
    parts.append(unicodedata.normalize("NFKC", "".join(buf)))
    return "".join(parts)


def normalize_text(
    text: str,
    add_dummy_prefix: bool = True,
    remove_extra_whitespaces: bool = True,
    escape_whitespace: bool = True,
) -> str:
    """SentencePiece nmt_nfkc normalization + whitespace treatment.

    After the charsmap every whitespace is a literal U+0020 (NFKC folds
    the Unicode space family to it; the NMT overrides fold the rest) —
    matching spm, code points it leaves alone (e.g. U+0085 NEL) stay in
    words rather than splitting them.
    """
    text = _nmt_nfkc(text)
    if remove_extra_whitespaces:
        text = " ".join(t for t in text.split(" ") if t != "")
    if not text:
        return ""
    if add_dummy_prefix:
        text = " " + text
    if escape_whitespace:
        text = text.replace(" ", SPACE)
    return text


class BpeEncoder:
    """Encode/decode with a loaded :class:`SpmModel` (BPE pieces + scores)."""

    def __init__(self, model: SpmModel):
        self.model = model
        self.piece_to_id_map: Dict[str, int] = {}
        self.scores: Dict[str, float] = {}
        self.user_defined: List[str] = []
        self.unk_id = 0
        self._control_ids = set()
        for idx, p in enumerate(model.pieces):
            if p.piece not in self.piece_to_id_map:
                self.piece_to_id_map[p.piece] = idx
                self.scores[p.piece] = p.score
            if p.type == PIECE_USER_DEFINED:
                self.user_defined.append(p.piece)
            elif p.type == PIECE_UNKNOWN:
                self.unk_id = idx
            elif p.type == PIECE_CONTROL:
                self._control_ids.add(idx)
        # longest-first for greedy matching
        self.user_defined.sort(key=len, reverse=True)
        self._native = BpeVocab([p.piece for p in model.pieces],
                                [float(p.score) for p in model.pieces])

    # ------------------------------------------------------------- encoding
    def _split_user_defined(self, text: str) -> List[Tuple[str, bool]]:
        """Split text into (segment, is_user_defined) runs, leftmost-longest."""
        if not self.user_defined:
            return [(text, False)]
        out: List[Tuple[str, bool]] = []
        i, n = 0, len(text)
        plain_start = 0
        while i < n:
            matched: Optional[str] = None
            for sym in self.user_defined:
                if text.startswith(sym, i):
                    matched = sym
                    break
            if matched is not None:
                if plain_start < i:
                    out.append((text[plain_start:i], False))
                out.append((matched, True))
                i += len(matched)
                plain_start = i
            else:
                i += 1
        if plain_start < n:
            out.append((text[plain_start:], False))
        return out

    def _bpe_segment(self, segment: str) -> List[int]:
        """Greedy highest-score pair merging over one segment."""
        if not segment:
            return []
        return self._native.encode(segment, self.unk_id)

    def _bpe_segment_plain(self, segment: str) -> List[int]:
        """:meth:`_bpe_segment` in pure Python."""
        if not segment:
            return []
        # symbols as a doubly-linked list over initial characters
        syms: List[str] = list(segment)
        nxt = list(range(1, len(syms) + 1))
        prv = list(range(-1, len(syms) - 1))
        alive = [True] * len(syms)

        heap: List[Tuple[float, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j >= len(syms):
                return
            merged = syms[i] + syms[j]
            score = self.scores.get(merged)
            if score is not None:
                heapq.heappush(heap, (-score, i, merged))

        for i in range(len(syms) - 1):
            push(i)

        while heap:
            neg_score, i, merged = heapq.heappop(heap)
            if not alive[i]:
                continue
            j = nxt[i]
            if j >= len(syms) or not alive[j] or syms[i] + syms[j] != merged:
                continue  # stale heap entry
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < len(syms):
                prv[nxt[i]] = i
            push(i)
            if prv[i] >= 0:
                push(prv[i])

        ids: List[int] = []
        i = 0
        while i < len(syms):
            if alive[i]:
                pid = self.piece_to_id_map.get(syms[i])
                if pid is None:
                    # unknown: emit per original character
                    for ch in syms[i]:
                        ids.append(self.piece_to_id_map.get(ch, self.unk_id))
                else:
                    ids.append(pid)
            i = nxt[i] if i < len(nxt) else i + 1
        return ids

    def encode_as_ids(self, text: str) -> List[int]:
        norm = normalize_text(text)
        ids: List[int] = []
        for segment, is_uds in self._split_user_defined(norm):
            if is_uds:
                ids.append(self.piece_to_id_map[segment])
            else:
                ids.extend(self._bpe_segment(segment))
        return ids

    def encode_as_pieces(self, text: str) -> List[str]:
        return [self.id_to_piece(i) for i in self.encode_as_ids(text)]

    # ------------------------------------------------------------- decoding
    def decode_ids(self, ids: List[int]) -> str:
        parts: List[str] = []
        for i in ids:
            i = int(i)
            if i < 0 or i >= len(self.model.pieces) or i in self._control_ids:
                continue
            if i == self.unk_id:
                parts.append(UNK_SURFACE)
                continue
            parts.append(self.model.pieces[i].piece)
        text = "".join(parts).replace(SPACE, " ")
        return text.lstrip(" ")

    def decode_pieces(self, pieces: List[str]) -> str:
        return self.decode_ids(
            [self.piece_to_id_map.get(p, self.unk_id) for p in pieces]
        )

    # ---------------------------------------------------------------- vocab
    def piece_to_id(self, piece: str) -> int:
        return self.piece_to_id_map.get(piece, self.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.model.pieces[idx].piece

    def vocab_size(self) -> int:
        return len(self.model.pieces)
