"""The port's tokenizer against the JAX package's.

Each package trains the fixture corpus's BPE tokenizer
(``tests/fixtures.py::make_corpus``, the joint ``transcription_and_
translation`` text, ``[es],[en],[turn],[xt]`` as user symbols, vocab
150) through its own ``SentencePiece`` wrapper. The two ``.model`` files
must be byte-equal, with the same pieces, scores and types, and encoding
and decoding must agree on every fixture text and on text that exercises
normalization and unknown characters. ``train_bpe`` itself is held to the
JAX function under other settings (coverage, duplicated symbols) and the
wire format round trip on a model with fields it does not interpret.
"""

import json

import pytest

from stac_st_tpu.tokenizer import SentencePiece as JSentencePiece
from stac_st_tpu.tokenizer import SpmModel as JSpmModel
from stac_st_tpu.tokenizer import normalize_text as j_normalize
from stac_st_tpu.tokenizer import train_bpe as j_train_bpe

from stac_st_tpu_torch.tokenizer import (
    SentencePiece,
    SpmModel,
    normalize_text,
    train_bpe,
)

from fixtures import make_corpus

SYMBOLS = "[es],[en],[turn],[xt]"
ODD_TEXTS = [
    "", "  hola   como  ", "[es] [en] hola", "hola[turn]como [xt]",
    "Ｈｏｌａ\tamigo claro", "ñandú café ☃", "x▁y", "\u0007si­",
    "[turn] [xt] [turn]", "HOLA gracias.",
]


def _train(cls, root, joint):
    return cls(model_dir=root, vocab_size=150, annotation_train=joint,
               annotation_read="transcription_and_translation",
               model_type="bpe", user_defined_symbols=SYMBOLS,
               bos_id=1, eos_id=2, unk_id=0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    _, st, joint = make_corpus(str(root), n_utts=16, multi_turn_every=3)
    got = _train(SentencePiece, str(tmp_path_factory.mktemp("port")), joint)
    want = _train(JSentencePiece, str(tmp_path_factory.mktemp("jax")), joint)
    texts = [v for e in json.load(open(st)).values()
             for v in (e["transcription"], e["translation_0"])]
    lines = [e["transcription_and_translation"]
             for e in json.load(open(joint)).values()]
    return dict(got=got, want=want, texts=texts + ODD_TEXTS, lines=lines)


def test_trained_model_files_are_byte_equal(pair):
    got, want = pair["got"], pair["want"]
    with open(got.model_path, "rb") as f, open(want.model_path, "rb") as g:
        assert f.read() == g.read()
    with open(got.vocab_path) as f, open(want.vocab_path) as g:
        assert f.read() == g.read()
    m, w = SpmModel.load(got.model_path), JSpmModel.load(want.model_path)
    assert [(p.piece, p.score, p.type) for p in m.pieces] == \
        [(p.piece, p.score, p.type) for p in w.pieces]
    assert [p.piece for p in m.pieces[:7]] == \
        ["<unk>", "<s>", "</s>", "[es]", "[en]", "[turn]", "[xt]"]
    assert got.sp.get_piece_size() == want.sp.get_piece_size() > 50


def test_encode_and_decode_match_jax(pair):
    got, want = pair["got"].sp, pair["want"].sp
    for text in pair["texts"]:
        ids = got.encode_as_ids(text)
        assert ids == want.encode_as_ids(text), text
        assert got.encode_as_pieces(text) == want.encode_as_pieces(text)
        assert got.decode_ids(ids) == want.decode_ids(ids)
        assert normalize_text(text) == j_normalize(text)
    for piece in ("[es]", "[turn]", "▁hola", "<unk>", "zz"):
        assert got.piece_to_id(piece) == want.piece_to_id(piece)
    every = list(range(got.get_piece_size()))
    assert got.decode_ids(every) == want.decode_ids(every)
    assert [got.id_to_piece(i) for i in every] == \
        [want.id_to_piece(i) for i in every]


@pytest.mark.parametrize("kw", [
    dict(vocab_size=60, user_defined_symbols=["[es]", "[en]", "[es]"]),
    dict(vocab_size=90, user_defined_symbols=["[turn]"],
         character_coverage=0.95)])
def test_train_bpe_matches_jax(pair, kw):
    got = train_bpe(pair["lines"] + ODD_TEXTS, **kw)
    want = j_train_bpe(pair["lines"] + ODD_TEXTS, **kw)
    assert got.to_bytes() == want.to_bytes()
    with pytest.raises(NotImplementedError):
        train_bpe(pair["lines"], vocab_size=60, pad_id=3)


def test_model_wire_format_round_trip_matches_jax(pair):
    """Fields the reader does not interpret (here a trainer_spec-like
    field 2 and an unknown fixed32) survive a load/save in both."""
    raw = open(pair["want"].model_path, "rb").read()
    raw += bytes([0x12, 3, 0x08, 0x96, 0x01]) + bytes([0x7D, 1, 2, 3, 4])
    got, want = SpmModel.from_bytes(raw), JSpmModel.from_bytes(raw)
    assert got.extra_fields == want.extra_fields
    assert got.to_bytes() == want.to_bytes()
    assert SpmModel.from_bytes(got.to_bytes()).to_bytes() == got.to_bytes()
