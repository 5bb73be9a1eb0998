"""The port's long-form protocol scripts against the JAX package's.

``build_conversations`` and ``score_grid_point`` equal the JAX script's
on the same corpus and hypothesis dicts; one run of the port's
``run_full_protocol.main`` on the CPU at ``tests/test_full_protocol.py``'s
size (table keys, finite numbers); ``run_default`` builds the JAX
script's recipe command lines (both recipe mains monkeypatched); the
port's entry points run on cuda unless told otherwise, and raise without
it."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stac_st_tpu_torch import run_default as p_run_default
from stac_st_tpu_torch.evaluations.vad_shas import run_full_protocol as pproto
from stac_st_tpu_torch.examples.fixtures import make_corpus

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "evaluations", "vad_shas"))
sys.path.insert(0, ROOT)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _split(workdir):
    make_corpus(os.path.join(workdir, "split_0"), n_utts=8, seconds=0.5,
                seconds_jitter=0.4, seed=0, multi_turn_every=3)


def _hyp(rng, text):
    """A hypothesis from a reference: dropped and repeated words."""
    words = [w for w in text.split() if rng.uniform() > 0.2]
    if words and rng.uniform() < 0.5:
        words.insert(int(rng.integers(0, len(words))), words[0])
    return " ".join(words)


def test_conversations_and_grid_scores_equal_jax(tmp_path):
    import run_full_protocol as jproto

    built = []
    for name, mod in (("jax", jproto), ("port", pproto)):
        d = str(tmp_path / name)
        _split(d)
        built.append((d, mod.build_conversations(d, n_convs=2,
                                                 utts_per_conv=4)))
    (jd, (jconvs, jman, _)), (pd, (pconvs, pman, _)) = built
    assert [c["ref_uids"] for c in jconvs] == [c["ref_uids"] for c in pconvs]
    for jc, pc in zip(jconvs, pconvs):
        assert jc["uri"] == pc["uri"]
        np.testing.assert_array_equal(jc["wav"], pc["wav"])
    assert json.loads(json.dumps(jman).replace(jd, "<d>")) == \
        json.loads(json.dumps(pman).replace(pd, "<d>"))

    rng = np.random.default_rng(4)
    results = []
    for conv in pconvs:
        segs = [{"transcription": _hyp(rng, pman[u]["transcription"]),
                 "translation": _hyp(rng, pman[u]["translation_0"])}
                for u in conv["ref_uids"]]
        raw = {k: " ".join(s[k] for s in segs)
               for k in ("transcription", "translation")}
        results.append({"raw": raw, **{k: pproto.strip_markers(v)
                                       for k, v in raw.items()}})
    for with_markers in (False, True):
        got = pproto.score_grid_point(pconvs, pman, results, with_markers)
        want = jproto.score_grid_point(jconvs, jman, results, with_markers)
        assert got == want
        assert 0.0 < got[0] < 100.0 and 0.0 < got[1] < 100.0


def test_full_protocol_runs_on_the_cpu(tmp_path):
    from stac_st_tpu_torch.eval.speaker_change import TOLERANCE_GRID

    rows, f1_rows = pproto.main([
        "--epochs", "2", "--utts", "8", "--convs", "1",
        "--utts-per-conv", "3", "--grid", "pause,shas_3_6",
        "--workdir", str(tmp_path), "--device", "cpu",
    ])
    assert [r["grid"] for r in rows] == ["pause", "shas_3_6"]
    for r in rows:
        assert set(r) == {"grid", "segments", "st_bleu", "asr_wer",
                          "st_bleu_with_turns", "asr_wer_with_turns"}
        assert r["segments"] >= 1
        assert all(np.isfinite(v) for k, v in r.items() if k != "grid")
    assert 2 <= rows[0]["segments"] <= 4
    assert rows[1]["segments"] <= rows[0]["segments"]
    assert [d["tolerance"] for d in f1_rows] == list(TOLERANCE_GRID)
    for d in f1_rows:
        assert set(d) == {"tolerance", "precision", "recall", "f1", "MDR",
                          "FAR", "TP", "FP", "FN"}
        assert all(np.isfinite(v) for v in d.values())
        assert 0.0 <= d["f1"] <= 1.0


@pytest.mark.parametrize("have_tokenizer", [False, True])
def test_run_default_builds_the_jax_command_lines(tmp_path, monkeypatch,
                                                  have_tokenizer):
    import recipes.train_multitask as j_train
    import recipes.train_tokenizer as j_tok
    import run_default as j_run_default
    from stac_st_tpu_torch.recipes import train_multitask as p_train
    from stac_st_tpu_torch.recipes import train_tokenizer as p_tok

    tok_dir = tmp_path / "tok"
    if have_tokenizer:
        tok_dir.mkdir()
        (tok_dir / "5000_bpe.model").write_bytes(b"")
    args = ["--data_folder", str(tmp_path / "data"), "--tokenizer_dir",
            str(tok_dir), "--seed", "7", "--number_of_epochs=3",
            "--device=cpu"]
    calls = {}
    for side, tok_mod, train_mod in (("jax", j_tok, j_train),
                                     ("port", p_tok, p_train)):
        calls[side] = []
        for mod, tag in ((tok_mod, "tokenizer"), (train_mod, "train")):
            monkeypatch.setattr(
                mod, "main", lambda argv, tag=tag, side=side:
                calls[side].append((tag, list(argv))))
    monkeypatch.setattr(sys, "argv", ["run_default.py", *args])
    j_run_default.main()
    p_run_default.main(args)
    assert calls["port"] == calls["jax"]
    assert [tag for tag, _ in calls["port"]] == \
        (["train"] if have_tokenizer else ["tokenizer", "train"])
    assert calls["port"][-1][1][-2:] == ["--number_of_epochs=3",
                                         "--device=cpu"]


class _StubTokenizer:
    def __init__(self, path):
        pass

    def piece_to_id(self, piece):
        return 5


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    from stac_st_tpu_torch.examples import quickstart
    from stac_st_tpu_torch.tools import eval_flagship

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pproto.main(["--epochs", "1", "--utts", "4", "--workdir",
                     str(tmp_path / "proto")])
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main(["--workdir", str(tmp_path / "qs"), "--epochs", "1"])
    for flags, device in (([], "cuda"), (["--cpu"], "cpu"),
                          (["--device", "cpu"], "cpu")):
        seen = {}

        def engine(*a, **kw):
            seen.update(kw)
            raise RuntimeError("stop")

        monkeypatch.setattr(eval_flagship.glob, "glob",
                            lambda pattern: ["tok/5000_bpe.model"])
        monkeypatch.setattr("stac_st_tpu_torch.tokenizer."
                            "SentencePieceProcessor", _StubTokenizer)
        monkeypatch.setattr("stac_st_tpu_torch.serving.STEngine."
                            "from_saved_experiment", engine)
        with pytest.raises(RuntimeError, match="stop"):
            eval_flagship.main(["--exp", "e", "--data", "d", *flags])
        assert seen["device"] == device
