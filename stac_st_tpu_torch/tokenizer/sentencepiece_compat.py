"""Drop-in ``sentencepiece.SentencePieceProcessor`` API surface (a copy of
``stac_st_tpu/tokenizer/sentencepiece_compat.py``).

The reference instantiates ``sentencepiece.SentencePieceProcessor`` straight
from YAML (``transformer_multitask.yaml:36``) and calls ``load_collected``
via the Pretrainer to point it at the ``.model`` file
(``train_multitask.py:644-645``). This class provides the same call surface
backed by :mod:`stac_st_tpu_torch.tokenizer.bpe`.
"""

from __future__ import annotations

from typing import List, Optional

from .bpe import BpeEncoder
from .spm_model import SpmModel

__all__ = ["SentencePieceProcessor"]


class SentencePieceProcessor:
    def __init__(self, model_file: Optional[str] = None):
        self._encoder: Optional[BpeEncoder] = None
        if model_file is not None:
            self.load(model_file)

    # --- loading --------------------------------------------------------
    def load(self, path: str) -> None:
        self._encoder = BpeEncoder(SpmModel.load(path))

    Load = load  # sentencepiece exposes both spellings

    def _enc(self) -> BpeEncoder:
        if self._encoder is None:
            raise RuntimeError("tokenizer model not loaded")
        return self._encoder

    # --- encoding / decoding -------------------------------------------
    def encode_as_ids(self, text: str) -> List[int]:
        return self._enc().encode_as_ids(text)

    def encode_as_pieces(self, text: str) -> List[str]:
        return self._enc().encode_as_pieces(text)

    def decode_ids(self, ids: List[int]) -> str:
        return self._enc().decode_ids(list(map(int, ids)))

    def decode_pieces(self, pieces: List[str]) -> str:
        return self._enc().decode_pieces(pieces)

    def encode(self, text: str, out_type=int):
        if out_type is int:
            return self.encode_as_ids(text)
        return self.encode_as_pieces(text)

    def decode(self, ids_or_pieces):
        if ids_or_pieces and isinstance(ids_or_pieces[0], str):
            return self.decode_pieces(ids_or_pieces)
        return self.decode_ids(ids_or_pieces)

    EncodeAsIds = encode_as_ids
    EncodeAsPieces = encode_as_pieces
    DecodeIds = decode_ids
    DecodePieces = decode_pieces

    # --- vocab ----------------------------------------------------------
    def piece_to_id(self, piece: str) -> int:
        return self._enc().piece_to_id(piece)

    def id_to_piece(self, idx: int) -> str:
        return self._enc().id_to_piece(idx)

    def get_piece_size(self) -> int:
        return self._enc().vocab_size()

    def vocab_size(self) -> int:
        return self._enc().vocab_size()

    def __len__(self) -> int:
        return self._enc().vocab_size()
