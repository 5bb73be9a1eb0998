"""SentencePiece-compatible BPE tokenizer: train / encode / decode / IO
(copies of ``stac_st_tpu/tokenizer/``; the trained ``.model`` files are
byte-equal)."""

from .bpe import BpeEncoder, normalize_text
from .sentencepiece_compat import SentencePieceProcessor
from .spm_model import Piece, SpmModel
from .train import SentencePiece, train_bpe

__all__ = [
    "BpeEncoder",
    "normalize_text",
    "SentencePieceProcessor",
    "Piece",
    "SpmModel",
    "SentencePiece",
    "train_bpe",
]
