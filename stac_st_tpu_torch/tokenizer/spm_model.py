"""SentencePiece ``.model`` file IO (protobuf wire format, no C++ deps; a
copy of ``stac_st_tpu/tokenizer/spm_model.py``).

The reference treats the SentencePiece model as a frozen contract: the
tokenizer is trained once (reference ``stac-st/train_tokenizer.py`` +
``hparams/train_bpe_5k_special_prefix.xx_to_xx.yaml:20-43``) and every recipe
loads the same ``.model`` file (``transformer_multitask.yaml:35-36``). The
``sentencepiece`` C++ library is not a dependency of this package, so this
module speaks the ModelProto wire format directly: it can *load* models
trained by real SentencePiece and *save* models trained by
:mod:`stac_st_tpu_torch.tokenizer.train` in a format real SentencePiece can read.

Only the fields needed for BPE inference are materialized:

    ModelProto      { repeated SentencePiece pieces = 1; ... }
    SentencePiece   { optional string piece = 1; optional float score = 2;
                      optional Type type = 3 [default = NORMAL]; }
    Type            { NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4
                      UNUSED=5 BYTE=6 }

Everything else (trainer_spec, normalizer_spec) is preserved as opaque bytes
on load and re-emitted on save, keeping round-trips lossless.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["Piece", "SpmModel", "PIECE_NORMAL", "PIECE_UNKNOWN",
           "PIECE_CONTROL", "PIECE_USER_DEFINED", "PIECE_BYTE"]

PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_UNUSED = 5
PIECE_BYTE = 6


@dataclass
class Piece:
    piece: str
    score: float = 0.0
    type: int = PIECE_NORMAL


@dataclass
class SpmModel:
    pieces: List[Piece] = field(default_factory=list)
    # opaque (field_number, wire_type, raw_bytes) triples we don't interpret
    extra_fields: List[Tuple[int, int, bytes]] = field(default_factory=list)

    # ---------------------------------------------------------- wire helpers
    @staticmethod
    def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
        result = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result, pos
            shift += 7
            if shift > 63:
                raise ValueError("varint too long")

    @staticmethod
    def _write_varint(value: int) -> bytes:
        out = bytearray()
        while True:
            bits = value & 0x7F
            value >>= 7
            if value:
                out.append(bits | 0x80)
            else:
                out.append(bits)
                return bytes(out)

    @classmethod
    def _parse_piece(cls, buf: bytes) -> Piece:
        pos = 0
        piece = ""
        score = 0.0
        ptype = PIECE_NORMAL
        n = len(buf)
        while pos < n:
            key, pos = cls._read_varint(buf, pos)
            fnum, wt = key >> 3, key & 7
            if fnum == 1 and wt == 2:
                ln, pos = cls._read_varint(buf, pos)
                piece = buf[pos:pos + ln].decode("utf-8")
                pos += ln
            elif fnum == 2 and wt == 5:
                (score,) = struct.unpack("<f", buf[pos:pos + 4])
                pos += 4
            elif fnum == 3 and wt == 0:
                ptype, pos = cls._read_varint(buf, pos)
            else:
                pos = cls._skip_field(buf, pos, wt)
        return Piece(piece, score, ptype)

    @classmethod
    def _skip_field(cls, buf: bytes, pos: int, wire_type: int) -> int:
        if wire_type == 0:
            _, pos = cls._read_varint(buf, pos)
        elif wire_type == 1:
            pos += 8
        elif wire_type == 2:
            ln, pos = cls._read_varint(buf, pos)
            pos += ln
        elif wire_type == 5:
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        return pos

    # ---------------------------------------------------------------- IO API
    @classmethod
    def from_bytes(cls, buf: bytes) -> "SpmModel":
        model = cls()
        pos = 0
        n = len(buf)
        while pos < n:
            key, pos = cls._read_varint(buf, pos)
            fnum, wt = key >> 3, key & 7
            if fnum == 1 and wt == 2:
                ln, pos = cls._read_varint(buf, pos)
                model.pieces.append(cls._parse_piece(buf[pos:pos + ln]))
                pos += ln
            else:
                start = pos
                pos = cls._skip_field(buf, pos, wt)
                model.extra_fields.append((fnum, wt, buf[start:pos]))
        return model

    @classmethod
    def load(cls, path: str) -> "SpmModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    def to_bytes(self) -> bytes:
        out = bytearray()
        for p in self.pieces:
            body = bytearray()
            raw = p.piece.encode("utf-8")
            body += self._write_varint((1 << 3) | 2)
            body += self._write_varint(len(raw))
            body += raw
            body += self._write_varint((2 << 3) | 5)
            body += struct.pack("<f", p.score)
            if p.type != PIECE_NORMAL:
                body += self._write_varint((3 << 3) | 0)
                body += self._write_varint(p.type)
            out += self._write_varint((1 << 3) | 2)
            out += self._write_varint(len(body))
            out += body
        for fnum, wt, raw in self.extra_fields:
            out += self._write_varint((fnum << 3) | wt)
            out += raw
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())
