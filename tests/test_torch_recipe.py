"""The port's experiment layer: YAML resolution against the JAX package's,
the model settings it loads and refuses, metrics against the JAX package's, resume and SIGTERM,
validation that searches the live weights, and the recipe end to end.

Tiny sizes (d32, 4 heads, 2 + 2 layers, vocab 150) through the
repository's own YAMLs, on the fixture corpus (``tests/fixtures.py``, 8
utterances of 0.5 s) with a tokenizer trained by the port. Tolerances:
scalar hparams, texts and metrics exactly equal; resume bitwise. The JAX
package is imported inside the tests that compare with it, so the card
twin of the end-to-end test runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_recipe.py
"""

import glob
import os
import signal
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu_torch.config import load_hyperpyyaml
from stac_st_tpu_torch.interop.from_jax import to_jax_params
from stac_st_tpu_torch.recipes import train_multitask as R
from stac_st_tpu_torch.training.trainer import STTrainer

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "recipes", "hparams", "transformer_multitask.yaml")
YAMLS = sorted(glob.glob(os.path.join(ROOT, "recipes", "hparams",
                                      "transformer_*.yaml")))
TINY = {"d_model": 32, "nhead": 4, "num_encoder_layers": 2,
        "num_decoder_layers": 2, "d_ffn": 64, "output_neurons": 150}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from stac_st_tpu_torch.tokenizer.train import SentencePiece

    root = str(tmp_path_factory.mktemp("recipe_corpus"))
    _, _, joint = make_corpus(root, n_utts=8, seconds=0.5)
    tok = SentencePiece(
        model_dir=root, vocab_size=150, annotation_train=joint,
        annotation_read="transcription_and_translation", model_type="bpe",
        user_defined_symbols="[es],[en],[turn],[xt]", bos_id=1, eos_id=2,
        unk_id=0)
    return {"root": root, "tokenizer": tok.model_path}


def _overrides(corpus, out, **more):
    """Tiny model, the fixture corpus, no speed perturbation (its first
    use imports scipy, seconds of test time; tests/test_torch_data.py
    holds it to the JAX package and the card runs the YAML's own)."""
    return {**TINY, "speed_perturb": None, "data_folder": corpus["root"],
            "tokenizer_file": corpus["tokenizer"], "output_folder": out,
            "train_splits": "data-st", "dev_splits": "data-st",
            "test_splits_4_translations": [],
            "test_splits_1_translations": ["data-asr"], "turn": 5, "xt": 6,
            "n_warmup_steps": 10, **more}


def _hparams(corpus, out, **more):
    """The canonical YAML at the tiny size, tokenizer loaded, seeded
    Glorot weights (as the recipe's ``main``)."""
    with open(YAML) as f:
        hp = load_hyperpyyaml(f, _overrides(corpus, str(out), **more))
    hp["pretrainer"].collect_files()
    hp["pretrainer"].load_collected()
    R.init_weights(hp)
    return hp


def _trainer(hp):
    return STTrainer(hp["modules"], hp["Adam"], hp, {"device": "cpu"},
                     hp["checkpointer"])


# ------------------------------------------------------------------ YAML
def _plain(value):
    """The value if it is plain data (scalars, and lists/tuples/dicts of
    them), else None."""
    if isinstance(value, (int, float, str, bool, type(None))):
        return value
    if isinstance(value, (list, tuple)):
        items = [_plain(v) for v in value]
        ok = all(i is not None or v is None for i, v in zip(items, value))
        return type(value)(items) if ok else None
    if isinstance(value, dict):
        items = {k: _plain(v) for k, v in value.items()}
        ok = all(items[k] is not None or value[k] is None for k in value)
        return items if ok else None
    return None


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_scalars_match_jax(path, tmp_path):
    """Both packages' loaders resolve the same YAML with the same tiny
    overrides to the same keys and the same scalar hparams (the objects
    are the port's: tests/test_torch_isolation.py)."""
    import yaml

    from stac_st_tpu.config import load_hyperpyyaml as jax_load
    from stac_st_tpu_torch.config.hyperyaml import Placeholder, _Loader

    text = open(path).read()
    raw = yaml.load(text, Loader=_Loader)
    ov = {k: v for k, v in TINY.items() if k in raw}
    ov.update({k: str(tmp_path / k) for k, v in raw.items()
               if isinstance(v, Placeholder) or k == "output_folder"})
    got, want = load_hyperpyyaml(text, ov), jax_load(text, ov)
    assert list(got) == list(want)
    scalars = {k: _plain(v) for k, v in want.items()
               if _plain(v) is not None}
    assert len(scalars) > 40
    assert {k: _plain(got[k]) for k in scalars} == scalars


def test_yaml_references_share_the_modules(corpus, tmp_path):
    """``!ref`` keeps identity: the searchers, ``modules``, ``model`` and
    the checkpointer's recoverables hold the very same modules, and the
    trainer's flat buffer is what they read."""
    hp = _hparams(corpus, tmp_path)
    mods = hp["modules"]
    assert [mods[k] for k in ("CNN", "Transformer", "seq_lin", "ctc_lin")] \
        == list(hp["model"])
    for searcher in (hp["valid_search"], hp["test_search"]):
        assert searcher.model is mods["Transformer"] is hp["Transformer"]
        assert searcher.seq_lin is mods["seq_lin"]
        assert searcher.ctc_lin is mods["ctc_lin"]
    rec = hp["checkpointer"].recoverables
    assert rec["model"] is hp["model"] and rec["normalizer"] is \
        mods["normalize"] and rec["counter"] is hp["epoch_counter"]
    trainer = _trainer(hp)
    flat = trainer.ensure_state().params.flat
    weight = mods["Transformer"].src_proj.weight
    assert weight.data_ptr() >= flat.data_ptr()
    assert weight.data_ptr() < flat.data_ptr() + flat.numel() * 4


# what each accepted edit loads into the port's modules; the edits not
# listed here the JAX package cannot run either
LOADED = {"normalize_before: False": False, "causal: True": True,
          'attention_type: "RelPosMHAXL"': "RelPosMHAXL",
          "encoder_module: conformer": "conformer",
          "residuals: (True, False)": (True, False),
          "num_layers_per_block: 2": 2}


@pytest.mark.parametrize("old,new,field", [
    ("normalize_before: True", "normalize_before: False",
     "normalize_before"),
    ("causal: False", "causal: True", "causal"),
    ('attention_type: "regularMHA"', 'attention_type: "RelPosMHAXL"',
     "attention_type"),
    ("encoder_module: transformer", "encoder_module: conformer",
     "encoder_module"),
    ("residuals: (False, False)", "residuals: (True, False)",
     "residuals[0]"),
    ("num_layers_per_block: 1", "num_layers_per_block: 2",
     "num_layers_per_block"),
    ("num_blocks: 2", "num_blocks: 3", "num_blocks"),
    ('attention_type: "regularMHA"', 'attention_type: "hypermixing"',
     "attention_type"),
])
def test_yaml_settings_the_port_cannot_run_raise(old, new, field, tmp_path):
    """Every setting the JAX package runs loads from the YAML into port
    modules that carry it; what the JAX package cannot run either (a
    third block of two ``out_channels``, an attention type it does not
    know) raises ``ValueError`` naming the field."""
    text = open(YAML).read()
    assert old in text
    ov = {**TINY, "data_folder": str(tmp_path), "tokenizer_file": "t",
          "output_folder": str(tmp_path)}
    if new not in LOADED:
        with pytest.raises(ValueError, match=field.replace("[", r"\[")):
            load_hyperpyyaml(text.replace(old, new), ov)
        return
    hp = load_hyperpyyaml(text.replace(old, new), ov)
    name = field.split("[")[0]
    owner = hp["CNN"] if name in ("residuals", "num_layers_per_block") \
        else hp["Transformer"]
    assert getattr(owner, name) == LOADED[new]
    assert hp["modules"]["Transformer"] is hp["Transformer"]


def test_yaml_lm_weight_loads_and_decodes_as_zero_until_set_lm(tmp_path):
    """``lm_weight: 0.5`` loads, as in the JAX package: the searcher
    decodes as with 0 until ``set_lm`` gives it an LM, which then acts
    with the YAML's weight."""
    from stac_st_tpu_torch.decoding.beam_search import MultiTaskBeamSearch

    text = open(YAML).read().replace("lm_weight: 0", "lm_weight: 0.5")
    ov = {**TINY, "data_folder": str(tmp_path), "tokenizer_file": "t",
          "output_folder": str(tmp_path)}
    s = load_hyperpyyaml(text, ov)["test_search"]
    assert s.config.lm_weight == 0.5
    ref = MultiTaskBeamSearch(s.model, s.seq_lin,
                              **{**s.config._asdict(), "lm_weight": 0.0})
    enc = torch.randn((2, 6, TINY["d_model"]),
                      generator=torch.Generator().manual_seed(0))
    for searcher in (s, ref):
        searcher.set_decoder_prefix_tokens(5, 6)
    (hyps, scores), (want, want_scores) = s(enc), ref(enc)
    assert hyps == want and torch.equal(scores, want_scores)
    favored = torch.full((TINY["output_neurons"],), -5.0)
    favored[7] = 5.0
    s.set_lm(lambda p, tokens, position, state:
             (p[None, :].expand(tokens.shape[0], -1), state), None, favored)
    hyps_lm, scores_lm = s(enc)
    assert hyps_lm != want and not torch.allclose(scores_lm, want_scores)


# --------------------------------------------------------------- metrics
def test_metrics_match_jax(corpus, tmp_path):
    """BLEU (one and four references), WER and ACC of fixed hypotheses,
    their stats files and CSVs, and the detokenized texts: the same as the
    JAX package's, exactly."""
    from stac_st_tpu.utils import metrics as JM
    from stac_st_tpu.utils import recipe_io as JIO
    from stac_st_tpu_torch.tokenizer import SentencePieceProcessor
    from stac_st_tpu_torch.utils import metrics as PM
    from stac_st_tpu_torch.utils import recipe_io as PIO

    sp = SentencePieceProcessor(corpus["tokenizer"])
    special = {"[turn]": 5, "[xt]": 6}
    ids = ["a-1", "a-2", "b-1"]
    refs = ["hola como estas [turn] bien", "buenos dias amigo",
            "que si [turn] [xt] claro"]
    hyps = [sp.encode_as_ids(t) for t in ("hola como [turn] bien bien",
                                          "buenos dias", "que [xt] claro")]
    four = [refs, [r.replace("hola", "claro") for r in refs], refs,
            [r[::-1] for r in refs]]
    rng = np.random.default_rng(3)
    lp = np.log(rng.dirichlet(np.ones(7), (3, 9))).astype(np.float32)
    tgt = rng.integers(0, 7, (3, 11))
    tgt[:, :3] = lp[:, :3].argmax(-1)  # some hits
    lp[0, 1, 2] = lp[0, 1, 5] = lp[0, 1].max() + 1.0  # a tie: first wins
    lens = np.asarray([1.0, 0.5, 0.27], np.float32)
    out = {}
    for tag, M, IO in (("port", PM, PIO), ("jax", JM, JIO)):
        res = {}
        bleu, bleu_nt, wer = M.BLEUStats(), M.BLEUStats(), M.ErrorRateStats()
        i, t, p = IO.append_gt_preds(ids, refs, hyps, "en", sp)
        _, t_nt, p_nt = IO.append_gt_preds(ids, refs, hyps, "en", sp, True,
                                           special)
        targets, targets_nt = IO.append_4gt(four, "en", special)
        bleu.append(i, p, targets)
        bleu_nt.append(i, p_nt, [t_nt])
        wer.append(i, [x.split(" ") for x in p], [x.split(" ") for x in t])
        acc = M.AccuracyStats()
        acc.append(torch.from_numpy(lp) if tag == "port" else lp, tgt, lens)
        for name, stats, is_bleu in (("bleu", bleu, True),
                                     ("bleu_nt", bleu_nt, True),
                                     ("wer", wer, False)):
            path = str(tmp_path / f"{tag}_{name}.txt")
            IO.print_bleu_or_wer(stats, path, is_bleu=is_bleu)
            res[name] = [open(path).read(),
                         open(path.replace(".txt", ".csv")).read()]
        res.update(texts=(t, p, t_nt, p_nt, targets, targets_nt),
                   bleu=bleu.summarize(), wer=wer.summarize(),
                   acc=acc.summarize())
        out[tag] = res
    assert out["port"] == out["jax"]
    assert 0 < out["port"]["bleu"]["BLEU"] < 100
    assert 0 < out["port"]["acc"] < 1


def _token_streams(seed, n=300):
    """Seeded token lists mixing words, punctuation, quotes, contractions,
    currency, brackets, CJK and XML entities."""
    rng = np.random.default_rng(seed)
    vocab = ["hola", "the", "Jones", "cats", "l'", "homme", "EU:", "n",
             "ssa", "'s", "'re", "'", '"', "``", "''", "„", "“", "”", "`",
             ".", ",", "?", "!", ":", ";", "%", ")", "]", "}", "(", "[",
             "$", "€", "¿", "¡", "3", ".5", "12", "-", "li", "mail", "de",
             "&amp;", "&lt;", "&quot;", "&apos;", "&#124;", "@-@", "漢字",
             "中", "한국", "...", "it's", "co-op", "Αθήνα", "Москва", "ñu",
             "'él"]
    return [[str(w) for w in rng.choice(vocab, rng.integers(1, 12))]
            for _ in range(n)]


@pytest.mark.parametrize("lang", ["en", "es"])
def test_detokenizer_matches_sacremoses(lang):
    """The port's Moses detokenizer (the card has no sacremoses) against
    sacremoses on seeded token streams, exactly, in the two languages the
    recipes detokenize."""
    from sacremoses import MosesDetokenizer as Reference

    from stac_st_tpu_torch.utils.detokenize import MosesDetokenizer

    ref, port = Reference(lang=lang), MosesDetokenizer(lang=lang)
    for tokens in _token_streams(sum(map(ord, lang))):
        assert port.detokenize(tokens) == ref.detokenize(tokens), tokens


def test_detokenizer_refuses_other_languages():
    from stac_st_tpu_torch.utils.detokenize import MosesDetokenizer

    with pytest.raises(ValueError, match="lang: 'fr'"):
        MosesDetokenizer(lang="fr")


def test_bleu_matches_sacrebleu():
    """The port's corpus BLEU (the card has no sacrebleu) against
    sacrebleu's defaults: one and four reference streams, missing
    references, orders without a match, digits, dashes and entities."""
    import sacrebleu

    from stac_st_tpu_torch.utils.bleu import corpus_bleu

    rng = np.random.default_rng(0)
    words = ["a", "b", "c", "d", "e", "3.5", "1,000", "x-1", "&amp;",
             "don't", "(b)", "e.", "<skipped>"]

    def line(k):
        return " ".join(rng.choice(words, k))

    for refs_n in (1, 4):
        for n_seg in (1, 7, 40):
            hyps = [line(rng.integers(1, 9)) for _ in range(n_seg)]
            refs = [[line(rng.integers(1, 9)) for _ in range(n_seg)]
                    for _ in range(refs_n)]
            if refs_n == 4:
                refs[3][0] = None
            want = sacrebleu.corpus_bleu(hyps, refs)
            got = corpus_bleu(hyps, refs)
            assert (got.score, got.bp, got.sys_len, got.ref_len,
                    got.precisions, got.counts, got.totals) == (
                want.score, want.bp, want.sys_len, want.ref_len,
                want.precisions, want.counts, want.totals)
    short = corpus_bleu(["a b"], [["a c d e f"]])
    assert short.score == sacrebleu.corpus_bleu(["a b"],
                                                [["a c d e f"]]).score


# ----------------------------------------------------- resume and SIGTERM
def _batches(hp, n):
    """The first ``n`` batches of the recipe's train loader, epoch 1."""
    _, loaders = R.dataio_prepare(hp)
    loaders["train"].set_epoch(1)
    batches = list(loaders["train"])
    assert len(batches) >= n
    return batches[:n]


def _state(trainer):
    st = trainer.state
    opt = st.opt_state
    return {"flat": st.params.flat, "mu": opt.mu, "nu": opt.nu,
            "count": opt.count, "notfinite": opt.notfinite,
            "mean": st.cmvn.mean, "std": st.cmvn.std, "n": st.cmvn.count,
            "gen": trainer.generator.get_state(),
            "ints": torch.tensor([st.optimizer_step, st.micro_step,
                                  opt.sched_count, opt.mini_step]),
            **({"acc": opt.acc} if opt.acc is not None else {})}


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(corpus, tmp_path):
    """Two steps, a checkpoint, a fresh trainer from the YAML that resumes
    and takes one step: parameters, Adam's moments and counts, CMVN, the
    counters and the step-seed generator equal three uninterrupted steps,
    bit for bit (dropout 0.1 and SpecAugment on, as the YAML ships
    them)."""
    more = dict(dynamic_batching=False, batch_size=2,
                grad_accumulation_factor=1)
    whole = _trainer(_hparams(corpus, tmp_path / "whole", **more))
    batches = _batches(whole.hparams, 3)
    whole.fit([1], batches[:2])
    whole.fit([2], batches[2:])

    first_hp = _hparams(corpus, tmp_path / "run", **more)
    first = _trainer(first_hp)
    first.fit([1], batches[:2])
    first.checkpointer.save_checkpoint({"epoch": 1},
                                       first._checkpoint_trees(1))
    second = _trainer(_hparams(corpus, tmp_path / "run", **more))
    second.fit([2], batches[2:])
    assert second.state.micro_step == 3
    got, want = _state(second), _state(whole)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    moved = (got["flat"] - _state(first)["flat"]).abs().max()
    assert float(moved) > 0


class _Sigterm:
    """Forwards batches; raises SIGTERM in-process after the first."""

    def __init__(self, batches):
        self.batches, self.fired = batches, False

    def __iter__(self):
        for batch in self.batches:
            yield batch
            if not self.fired:
                self.fired = True
                signal.raise_signal(signal.SIGTERM)


def test_sigterm_saves_a_preempted_checkpoint_and_restores_handler(
        corpus, tmp_path):
    hp = _hparams(corpus, tmp_path, dynamic_batching=False, batch_size=2)
    trainer = _trainer(hp)
    calls = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: calls.append(s))
    try:
        feed = _Sigterm(_batches(hp, 3))
        trainer.fit(hp["epoch_counter"], feed)
        handler_after = signal.getsignal(signal.SIGTERM)
    finally:
        restored = signal.signal(signal.SIGTERM, prev)
    assert feed.fired and trainer.preempted and calls == [signal.SIGTERM]
    assert handler_after is restored
    # the step in flight ran: the signal lands while the next batch is
    # fetched, then fit saves and returns
    assert trainer.state.micro_step == 2
    ckpts = hp["checkpointer"].list_checkpoints()
    assert [c.meta.get("preempted") for c in ckpts] == [True]
    assert ckpts[0].load("counters") == {"epoch": 1, "micro_step": 2,
                                         "optimizer_step": 0}


def test_resume_inside_an_epoch_equals_an_uninterrupted_epoch(corpus,
                                                              tmp_path):
    """SIGTERM after the second batch of epoch 1 (accumulation 2); a fresh
    trainer from the YAML resumes from the preempted checkpoint, reads the
    two trained batches again without training them and trains the third:
    its state (the accumulator too) and the epoch's train loss equal one
    uninterrupted epoch, bit for bit."""
    more = dict(dynamic_batching=False, batch_size=2,
                grad_accumulation_factor=2, number_of_epochs=1)
    whole_hp = _hparams(corpus, tmp_path / "whole", **more)
    whole = _trainer(whole_hp)
    batches = _batches(whole_hp, 3)
    whole.fit(whole_hp["epoch_counter"], batches)

    prev = signal.signal(signal.SIGTERM, lambda s, f: None)
    try:
        first_hp = _hparams(corpus, tmp_path / "run", **more)
        first = _trainer(first_hp)
        first.fit(first_hp["epoch_counter"], _Sigterm(batches))
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert first.preempted and first.state.micro_step == 2
    second_hp = _hparams(corpus, tmp_path / "run", **more)
    second = _trainer(second_hp)
    second.fit(second_hp["epoch_counter"], batches)
    assert not second.preempted and second.state.micro_step == 3
    got, want = _state(second), _state(whole)
    assert set(got) == set(want) and "acc" in want
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert second.train_stats == whole.train_stats
    assert second_hp["epoch_counter"].current == 1


def test_validation_search_reads_the_live_weights(corpus, tmp_path):
    """The YAML's searcher decodes with the trainer's weights as they are:
    the same encoder output scores differently after one step, and the
    search (inference mode) leaves the next step's autograd unaffected."""
    hp = _hparams(corpus, tmp_path, dynamic_batching=False, batch_size=2,
                  grad_accumulation_factor=1, lr_adam=0.05)
    trainer = _trainer(hp)
    batches = _batches(hp, 2)
    dev = trainer._device_batch(batches[0])
    _, _, enc = trainer.eval_forward(trainer.ensure_state().params,
                                     trainer.state.cmvn, dev)
    searcher = hp["valid_search"]
    searcher.set_decoder_prefix_tokens(3, 4)
    _, before = searcher(enc)
    trainer.fit([1], batches[:1])
    _, after = searcher(enc)
    assert not torch.equal(before, after)
    trainer.fit([2], batches[1:])
    assert np.isfinite(trainer.train_stats["loss"])


# ------------------------------------------------------------ the recipe
def _assert_engine_holds(engine, avg):
    """The engine's weights are the tree ``avg`` (JAX layout), bitwise."""
    got = to_jax_params(engine._cnn, engine._transformer,
                        engine.searcher.seq_lin, engine._ctc_lin)
    flat = {}
    for tree, tag in ((got, "got"), (avg, "want")):
        leaves = []
        _flatten(tree, "", leaves)
        flat[tag] = leaves
    assert [k for k, _ in flat["got"]] == [k for k, _ in flat["want"]]
    for (key, g), (_, w) in zip(flat["got"], flat["want"]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), key


def _average(out):
    from stac_st_tpu_torch.training.checkpoint import (
        Checkpointer,
        average_checkpoints,
    )

    ckpts = Checkpointer(os.path.join(out, "save")).find_checkpoints(
        max_key="ACC")
    assert len(ckpts) == 1
    return average_checkpoints(ckpts, "model")


def _run_recipe(corpus, out, device):
    """The recipe from the canonical YAML (one epoch, search on, one test
    split), then the experiment reloaded by STEngine."""
    from stac_st_tpu_torch.serving import STEngine

    # the card's decode kernels take heads of 64
    heads = {"d_model": 128, "nhead": 2} if device == "cuda" else {}
    args = [YAML, f"--device={device}"] + [
        f"--{k}={'null' if v is None else v}" for k, v in _overrides(
            corpus, out, number_of_epochs=1, valid_search_interval=1,
            num_workers=1, no_eval=False, batch_size=4,
            # the duration sampler (held to the JAX package in
            # tests/test_torch_data.py) imports scipy.stats, seconds of
            # test time
            dynamic_batching=False, **heads).items()]
    trainer = R.main(args)
    assert trainer.device.type == device
    stats = trainer.last_valid_stats
    assert {"loss", "ACC", "BLEU", "WER"} <= set(stats)
    files = sorted(f for f in os.listdir(out) if f.startswith("wer_"))
    assert files == ["wer_data-asr.csv", "wer_data-asr.txt",
                     "wer_data-asr_no_turn.csv", "wer_data-asr_no_turn.txt"]
    engine = STEngine.from_saved_experiment(out, device=device, bf16=False)
    _assert_engine_holds(engine, _average(out))
    wav = engine.load_audio(os.path.join(corpus["root"], "wav",
                                         "utt000.wav"))
    assert isinstance(engine.translate([wav])[0], str)


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}", out)
    else:
        out.append((prefix, np.asarray(tree)))


def test_recipes_default_to_cuda_and_raise_without_it(monkeypatch):
    """No ``--device``: the recipes ask for CUDA, and raise before any
    work where there is none; only ``--device=cpu`` runs on the CPU."""
    from stac_st_tpu_torch.config import parse_arguments
    from stac_st_tpu_torch.recipes import inference

    assert parse_arguments([YAML])[1]["device"] == "cuda"
    assert parse_arguments([YAML, "--device=cpu"])[1]["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (R.main, inference.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([YAML, "--data_folder=/nonexistent"])


@pytest.fixture(scope="module")
def cpu_experiment(corpus, tmp_path_factory):
    """The recipe's experiment on the CPU (``_run_recipe``), made once."""
    out = str(tmp_path_factory.mktemp("recipe") / "exp")
    _run_recipe(corpus, out, "cpu")
    return out


def test_recipe_end_to_end_on_cpu(corpus, cpu_experiment):
    """``--device=cpu``: train, validate with the dual search, keep the
    ACC checkpoint, evaluate the test split into its files, and reload
    the experiment with the averaged weights, bit for bit; then the
    inference recipe on that experiment writes the ASR and ST outputs and
    the CTC head's RTTM files."""
    from stac_st_tpu_torch.recipes import inference

    out = cpu_experiment
    root = corpus["root"]
    inference.main([
        os.path.join(ROOT, "recipes", "hparams", "transformer_inference.yaml"),
        "--device=cpu", f"--pretrained_path={out}",
        f"--tokenizer_file={corpus['tokenizer']}",
        f"--inference_splits={root}/data-st", f"--data_folder={root}",
        "--turn=5", "--xt=6", *(f"--{k}={v}" for k, v in TINY.items())])
    name = os.path.basename(root)
    assert sorted(os.listdir(os.path.join(out, "inference"))) == sorted([
        f"RTTM_{name}_turn.csv", f"RTTM_{name}_xt.csv",
        f"bleu_{name}-gt.csv", f"bleu_{name}-st.csv", f"wer_{name}-asr.csv",
        f"wer_{name}-gt.csv", "env.json", "hyperparams.yaml",
        "overrides.yaml"])


@pytest.mark.cuda
def test_recipe_end_to_end_on_card(corpus, tmp_path):
    """The same on the card, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _run_recipe(corpus, str(tmp_path / "exp"), "cuda")


def test_from_experiment_loads_the_average_and_warms_up(corpus,
                                                        cpu_experiment):
    """``STEngine.from_experiment`` (dimensions given, the YAML's CNN)
    loads the same experiment's averaged weights, bit for bit, and
    ``warmup`` serves every bucket once."""
    from stac_st_tpu_torch.serving import STEngine

    engine = STEngine.from_experiment(
        cpu_experiment, corpus["tokenizer"], d_model=TINY["d_model"],
        nhead=TINY["nhead"], num_encoder_layers=TINY["num_encoder_layers"],
        num_decoder_layers=TINY["num_decoder_layers"], d_ffn=TINY["d_ffn"],
        vocab=TINY["output_neurons"], device="cpu", bf16=False,
        beam_size=2, bucket_seconds=(0.5, 1.0))
    _assert_engine_holds(engine, _average(cpu_experiment))
    assert engine.warmup() == 2


def test_step_timer_rates():
    """The trainer's StepTimer on the CPU's clock: a window of step
    durations and the items (audio seconds) a second over it."""
    from stac_st_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer(window=2, device="cpu")
    assert timer.stats() == {} and not timer.cuda
    for items in (5.0, 1.0, 2.0, 3.0):
        timer.tick(items)
    stats = timer.stats()
    assert timer._items == [2.0, 3.0]
    assert stats["step_ms_p50"] >= 0 and stats["steps_per_sec"] > 0
    assert stats["items_per_sec"] == pytest.approx(
        5.0 * stats["steps_per_sec"] / 2)


@pytest.mark.cuda
def test_step_timer_reads_device_time_on_card():
    """On the card the timer records events and reads the device time
    between them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stac_st_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer(device="cuda")
    x = torch.randn(2048, 2048, device="cuda")
    for _ in range(4):
        x = (x @ x).tanh()
        timer.tick(1.0)
    stats = timer.stats()
    assert timer.cuda and 0 < stats["step_ms_p50"] < 1e3
    assert stats["items_per_sec"] > 0
