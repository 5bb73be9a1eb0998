"""BPE tokenizer training (SentencePiece-trainer-compatible surface; a copy
of ``stac_st_tpu/tokenizer/train.py``).

Re-owns the reference's tokenizer pipeline
(``stac-st/train_tokenizer.py`` + SpeechBrain's SentencePiece wrapper,
``hparams/train_bpe_5k_special_prefix.xx_to_xx.yaml:32-43``):

* reads the ``annotation_read`` field (e.g. ``transcription_and_translation``)
  from a JSON manifest;
* trains a BPE vocab of ``vocab_size`` pieces with ``user_defined_symbols``
  (the language/turn/xt tokens) pinned directly after the control pieces,
  yielding the frozen id contract <unk>=0 <s>=1 </s>=2, first user symbol=3...
  (reference ``transformer_multitask.yaml:138-149``);
* saves ``{model_dir}/{vocab_size}_{model_type}.model`` (+ ``.vocab``) in
  real SentencePiece wire format (see :mod:`..tokenizer.spm_model`).

Training algorithm: the SentencePiece C++ BPE trainer's own
(:mod:`.spm_bpe` ports ``bpe_model_trainer.cc``): pieces are emitted in
MERGE ORDER with scores ``-emission_index`` (selection ties broken by
shorter-then-lexicographic merged string), required characters appended
after the merges sorted by frequency — so both the piece/score layout and
the encode behavior match what ``spm_train`` would produce on the same
corpus. Byte-level certification needs the C++ binary and runs on-site via
``tools/verify_tokenizer.py`` (the sentencepiece package is not a dependency).

Note: the reference yaml expands ``user_defined_symbols`` to
``"[es],[en],[turn],[xt],[es],[en]"`` (duplicated languages); real
SentencePiece rejects duplicate symbols, so we de-duplicate preserving order
and log a warning (behavioral-fidelity note in SURVEY.md §7.4).
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

from .bpe import SPACE, normalize_text
from .spm_bpe import SpmBpeMergeEngine
from .spm_model import (
    PIECE_CONTROL,
    PIECE_NORMAL,
    PIECE_UNKNOWN,
    PIECE_USER_DEFINED,
    Piece,
    SpmModel,
)

logger = logging.getLogger(__name__)

__all__ = ["train_bpe", "SentencePiece"]


def _iter_words(
    lines: Iterable[str], user_defined: List[str]
) -> Counter:
    """Word-frequency counts with ▁ markers; user symbols removed."""
    counts: Counter = Counter()
    for line in lines:
        for sym in user_defined:
            line = line.replace(sym, " ")
        norm = normalize_text(line)
        if not norm:
            continue
        # normalize_text escapes every space to ▁ and adds a dummy prefix, so
        # words are exactly the ▁-prefixed runs.
        for word in norm.split(SPACE):
            if word:
                counts[SPACE + word] += 1
    return counts


def train_bpe(
    lines: Iterable[str],
    vocab_size: int = 5000,
    user_defined_symbols: Optional[List[str]] = None,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
    character_coverage: float = 1.0,
) -> SpmModel:
    """Train a BPE model; returns a :class:`SpmModel` ready to save."""
    user_defined = []
    seen = set()
    for sym in user_defined_symbols or []:
        if sym in seen:
            logger.warning("duplicate user_defined_symbol %r dropped", sym)
            continue
        seen.add(sym)
        user_defined.append(sym)

    word_freq = _iter_words(lines, user_defined)

    # --- required characters with coverage (TrainerInterface semantics:
    # chars sorted by freq desc / code point asc; stop BEFORE adding once
    # accumulated coverage reaches the target — coverage 1.0 keeps all) ---
    char_freq: Counter = Counter()
    for word, freq in word_freq.items():
        for ch in word:
            char_freq[ch] += freq
    total_chars = sum(char_freq.values()) or 1
    required_chars: List[Tuple[str, int]] = []  # (char, freq), spm order
    running = 0
    for ch, freq in sorted(char_freq.items(), key=lambda kv: (-kv[1], kv[0])):
        if running / total_chars >= character_coverage and required_chars:
            break
        required_chars.append((ch, freq))
        running += freq
    alphabet = {ch for ch, _ in required_chars}
    if SPACE not in alphabet:
        alphabet.add(SPACE)
        required_chars.append((SPACE, char_freq.get(SPACE, 0)))

    # sentences: deduped words (insertion order) over in-alphabet chars
    # (chars outside the coverage set are dropped from training)
    words: Dict[str, int] = {}
    for word, freq in word_freq.items():
        filtered = "".join(ch for ch in word if ch in alphabet)
        if filtered:
            words[filtered] = words.get(filtered, 0) + freq

    n_specials = 3 + len(user_defined)  # unk/bos/eos + user symbols
    # spm reserves the required chars up front: the merge budget is
    # vocab_size - meta pieces - required chars (bpe_model_trainer Train())
    n_mergeable = vocab_size - n_specials - len(required_chars)
    if n_mergeable < 0:
        raise ValueError(
            f"vocab_size={vocab_size} too small for alphabet "
            f"({len(required_chars)}) + specials ({n_specials})"
        )

    # --- spm-faithful merge loop (see spm_bpe.py for the fidelity notes) ---
    engine = SpmBpeMergeEngine(words.items())
    merges = engine.run(n_mergeable)

    # --- assemble pieces: specials, merges in merge order, then required
    # chars (freq desc / code point asc), scores = -emission_index ---
    pieces: List[Piece] = [
        Piece("<unk>", 0.0, PIECE_UNKNOWN),
        Piece("<s>", 0.0, PIECE_CONTROL),
        Piece("</s>", 0.0, PIECE_CONTROL),
    ]
    for sym in user_defined:
        pieces.append(Piece(sym, 0.0, PIECE_USER_DEFINED))

    index = 0
    for piece, _freq in merges:
        pieces.append(Piece(piece, float(-index), PIECE_NORMAL))
        index += 1
    for ch, _freq in required_chars:
        pieces.append(Piece(ch, float(-index), PIECE_NORMAL))
        index += 1

    if unk_id != 0 or bos_id != 1 or eos_id != 2 or pad_id != -1:
        raise NotImplementedError(
            "only the reference id layout unk=0 bos=1 eos=2 pad=-1 is "
            "supported (transformer_multitask.yaml:138-141)"
        )
    return SpmModel(pieces=pieces)


class SentencePiece:
    """SpeechBrain-style training wrapper (the YAML-facing class).

    Mirrors ``speechbrain.tokenizers.SentencePiece.SentencePiece``: training
    happens at construction when the model file is missing; the trained
    processor is exposed as ``.sp`` (reference tokenizer yaml:32-43).
    """

    def __init__(
        self,
        model_dir: str,
        vocab_size: int,
        annotation_train: Optional[str] = None,
        annotation_read: Optional[str] = None,
        model_type: str = "bpe",
        char_format_input: bool = False,
        character_coverage: float = 1.0,
        user_defined_symbols: Optional[str] = None,
        bos_id: int = -1,
        eos_id: int = -1,
        unk_id: int = 0,
        pad_id: int = -1,
        annotation_list_to_check: Optional[List[str]] = None,
        annotation_format: str = "json",
        **unused_kwargs,
    ):
        if model_type != "bpe":
            raise NotImplementedError(
                f"model_type={model_type!r}: the reference uses bpe "
                "(train_bpe_5k_special_prefix.xx_to_xx.yaml:21)"
            )
        os.makedirs(model_dir, exist_ok=True)
        vocab_size = int(vocab_size)
        prefix = os.path.join(model_dir, f"{vocab_size}_{model_type}")
        self.model_path = prefix + ".model"
        self.vocab_path = prefix + ".vocab"

        if not os.path.isfile(self.model_path):
            if annotation_train is None or annotation_read is None:
                raise ValueError(
                    "annotation_train/annotation_read required to train"
                )
            symbols = (
                [s for s in user_defined_symbols.split(",") if s]
                if user_defined_symbols
                else []
            )
            lines = self._read_annotation(
                annotation_train, annotation_read, annotation_format
            )
            logger.info(
                "training %d-piece BPE on %s[%s]",
                vocab_size, annotation_train, annotation_read,
            )
            model = train_bpe(
                lines,
                vocab_size=vocab_size,
                user_defined_symbols=symbols,
                unk_id=unk_id,
                bos_id=bos_id if bos_id >= 0 else 1,
                eos_id=eos_id if eos_id >= 0 else 2,
                pad_id=pad_id,
                character_coverage=character_coverage,
            )
            model.save(self.model_path)
            with open(self.vocab_path, "w") as f:
                for p in model.pieces:
                    f.write(f"{p.piece}\t{p.score:g}\n")

        from .sentencepiece_compat import SentencePieceProcessor

        self.sp = SentencePieceProcessor()
        self.sp.load(self.model_path)

    @staticmethod
    def _read_annotation(path: str, field: str, fmt: str) -> List[str]:
        if fmt != "json":
            raise NotImplementedError("only json annotation_format supported")
        with open(path) as f:
            data = json.load(f)
        lines = []
        for entry in data.values():
            value = entry.get(field)
            if value:
                lines.append(str(value))
        return lines

    def __call__(self):  # kept callable like the partial-then-call recipe use
        return self
