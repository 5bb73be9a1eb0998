"""The port's synthetic corpora against the JAX package's: the learnable
corpus (single- and multi-turn utterances), its long-form conversations,
the ASR+ST mixture and the fixture corpus. Same seeds and lexicon: every
wav file byte-equal, every manifest equal as JSON."""

import json
import os

import numpy as np
import pytest

from stac_st_tpu.data import synth as jsynth
from stac_st_tpu_torch.data import synth as psynth
from stac_st_tpu_torch.examples.fixtures import make_corpus

from fixtures import make_corpus as jax_make_corpus


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(a, b):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        if rel.endswith(".json"):
            # paths inside manifests name each package's own directory
            assert json.loads(ta[rel].decode().replace(str(a), "<root>")) == \
                json.loads(tb[rel].decode().replace(str(b), "<root>")), rel
        else:
            assert ta[rel] == tb[rel], rel


@pytest.fixture(scope="module")
def lexicons():
    jl, pl = jsynth.build_lexicon(200, seed=0), psynth.build_lexicon(200,
                                                                     seed=0)
    assert jl.words == pl.words
    return jl, pl


def test_synth_corpus_and_mixture_byte_equal(tmp_path, lexicons):
    """Eight utterances, multi_turn_frac 0.5: both single- and multi-turn
    rows (with their [turn] / [turn] [xt] markers and segment fields)."""
    jl, pl = lexicons
    ja, pa = tmp_path / "jax", tmp_path / "port"
    jpaths = jsynth.make_synth_corpus(str(ja), n_utts=8, seed=3, lexicon=jl,
                                      multi_turn_frac=0.5, prefix="t")
    ppaths = psynth.make_synth_corpus(str(pa), n_utts=8, seed=3, lexicon=pl,
                                      multi_turn_frac=0.5, prefix="t")
    jsynth.write_mixed_manifest(jpaths[0], jpaths[1], str(ja / "mixed.json"))
    psynth.write_mixed_manifest(ppaths[0], ppaths[1], str(pa / "mixed.json"))
    _assert_same_tree(ja, pa)
    with open(ppaths[1]) as f:
        turns = [e["nb_turns"] for e in json.load(f).values()]
    assert min(turns) == 1 and max(turns) > 1


def test_synth_conversations_byte_equal(tmp_path, lexicons):
    jl, pl = lexicons
    ja, pa = tmp_path / "jax", tmp_path / "port"
    jconvs, jman, _ = jsynth.make_synth_conversations(
        str(ja), jl, n_convs=2, utts_per_conv=3, seed=100)
    pconvs, pman, _ = psynth.make_synth_conversations(
        str(pa), pl, n_convs=2, utts_per_conv=3, seed=100)
    _assert_same_tree(ja, pa)
    assert [c["ref_uids"] for c in jconvs] == [c["ref_uids"] for c in pconvs]
    for jc, pc in zip(jconvs, pconvs):
        np.testing.assert_array_equal(jc["wav"], pc["wav"])


@pytest.mark.parametrize("kw", [
    dict(n_utts=6, seconds=0.5, seconds_jitter=0.4, seed=0,
         multi_turn_every=3),
    dict(n_utts=5, seconds=0.6, seed=2, multi_turn_every=4,
         sample_rate=8000)])
def test_fixture_corpus_byte_equal(tmp_path, kw):
    ja, pa = tmp_path / "jax", tmp_path / "port"
    jax_make_corpus(str(ja), **kw)
    make_corpus(str(pa), **kw)
    _assert_same_tree(ja, pa)
