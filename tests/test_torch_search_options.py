"""The searcher's options in the port against the JAX package's searcher.

The tiny model of ``test_beam_search.py`` (d32, 4 heads, 1 + 2 layers,
vocab 40, inputs of 16 features), its weights made with numpy from a seed
and carried into the port by ``interop.from_jax``, eos made competitive
(so hypotheses end early and late). The port's ``MultiTaskBeamSearch``
(fp32, CPU: the kernels' plain versions, anc mode at beam 3) against
``stac_st_tpu``'s at the serving configuration (eos threshold 1.5, length
normalization, temperature 1.15; beam 3), each JAX search run once for the
module (its jitted program), on numpy-seeded encoder outputs:

* joint CTC/attention decoding (ctc_weight 0.5) with
  ``mask_encoder_padding``, relative lengths below 1, ``call_multi`` over
  two prompts and ``__call__`` (one JAX program for both options); CTC
  weight 0 is the attention-only search;
* the padding mask is batch-shape invariant (an utterance alone equals it
  padded with noise frames);
* ``decode_tier`` on the settled path (eos-biased head) and the rerun
  path, and the tier pass's ``settled`` flags;
* the prompt setters.

Shallow LM fusion is held to JAX in ``test_torch_lm_fusion.py``, on this
file's fixture (a file of its own, so each stays under the test count
that would queue it ahead of the suite's longest JAX files).

Hypotheses must be equal, scores within atol 1e-4 (fp32; the two sides sum
in other orders).
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.decoding.beam_search import (
    MultiTaskBeamSearch as JaxSearcher,
    beam_search as jax_beam_search,
)
from stac_st_tpu.models import LinearHead, TransformerMultiTask
from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.decoding.beam_search import MultiTaskBeamSearch
from stac_st_tpu_torch.interop.from_jax import to_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import _seeded_leaf  # noqa: E402
from torch_once import built_once  # noqa: E402

D, VOCAB, IN = 32, 40, 16
ATOL = 1e-4
OPTS = dict(bos_index=1, eos_index=2, blank_index=0, min_decode_ratio=0.0,
            max_decode_ratio=1.0, beam_size=3, using_eos_threshold=True,
            eos_threshold=1.5, length_normalization=True, temperature=1.15)
PROMPTS = [[1, 5, 5], [1, 5, 9]]
WAV_LENS = np.asarray([1.0, 0.75], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _seed(module, rng):
    """Numpy-seeded weights in place: ``test_torch_model``'s rule (Glorot
    kernels, scales near 1, small nonzero biases), by parameter name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            kind = ("bias" if name.endswith("bias") else "scale"
                    if "norm" in name else "kernel")
            p.copy_(torch.from_numpy(
                _seeded_leaf([kind], tuple(p.shape), rng).astype(np.float32)))


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny model with numpy-seeded weights (eos bias +0.4),
    the JAX modules and the same weights as their tree
    (``interop.from_jax.to_jax_params``), an encoder output (2, 12, d) and
    CTC posteriors (2, 12, V)."""
    rng = np.random.default_rng(21)
    transformer = P.TransformerMultiTask(
        VOCAB, IN, d_model=D, nhead=4, num_encoder_layers=1,
        num_decoder_layers=2, d_ffn=64)
    head = P.LinearHead(D, VOCAB)
    for m in (transformer, head):
        _seed(m, rng)
    with torch.no_grad():
        head.linear.bias[2] += 0.4
    transformer.eval()
    params = jax.tree_util.tree_map(
        jnp.asarray, to_jax_params(transformer=transformer, seq_lin=head))
    model = TransformerMultiTask(
        tgt_vocab=VOCAB, input_size=IN, d_model=D, nhead=4,
        num_encoder_layers=1, num_decoder_layers=2, d_ffn=64, dropout=0.0,
        normalize_before=True)
    enc = rng.standard_normal((2, 12, D)).astype(np.float32)
    x = 2.0 * rng.standard_normal((2, 12, VOCAB)).astype(np.float32)
    ctc = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    return dict(model=model, seq_lin=LinearHead(input_size=D,
                                                n_neurons=VOCAB),
                params=params, transformer=transformer, head=head, enc=enc,
                ctc=ctc)


def jax_searcher(tiny, s_params=None, **kw):
    s = JaxSearcher([tiny["model"], tiny["seq_lin"], None],
                                   **{**OPTS, **kw})
    s.bind(tiny["params"]["Transformer"],
           tiny["params"]["seq_lin"] if s_params is None else s_params)
    return s


def port_searcher(tiny, head=None, **kw):
    return MultiTaskBeamSearch(tiny["transformer"], head or tiny["head"],
                               **{**OPTS, **kw})


def assert_same(got, want):
    (g_hyps, g_scores), (w_hyps, w_scores) = got, want
    assert g_hyps == w_hyps
    np.testing.assert_allclose(np.asarray(g_scores), np.asarray(w_scores),
                               atol=ATOL, rtol=0)


# ------------------------------------ joint CTC and the encoder-padding mask
@pytest.fixture(scope="module")
def jax_ctc(tiny, tmp_path_factory):
    """JAX's joint CTC search (weight 0.5) with the padding mask, over
    both prompts in one ``call_multi`` (built once a run)."""
    def build():
        s = jax_searcher(tiny, ctc_weight=0.5, mask_encoder_padding=True)
        fused = s.call_multi(jnp.asarray(tiny["enc"]), jnp.asarray(WAV_LENS),
                             prompts=PROMPTS,
                             ctc_log_probs=jnp.asarray(tiny["ctc"]))
        return [(hyps, np.asarray(scores)) for hyps, scores in fused]
    return built_once(tmp_path_factory, "torch_search_options_ctc", build)


def test_joint_ctc_with_the_padding_mask_matches_jax(tiny, jax_ctc):
    s = port_searcher(tiny, ctc_weight=0.5, mask_encoder_padding=True)
    enc, ctc = torch.from_numpy(tiny["enc"]), torch.from_numpy(tiny["ctc"])
    fused = s.call_multi(enc, torch.from_numpy(WAV_LENS), prompts=PROMPTS,
                         ctc_log_probs=ctc)
    for got, want in zip(fused, jax_ctc):
        assert_same(got, want)
    assert len({len(h) for h in fused[0][0] + fused[1][0]}) > 1
    s.set_decoder_prefix_tokens(5, 9)
    assert_same(s(enc, WAV_LENS, ctc_log_probs=ctc), jax_ctc[1])
    # each option moves the search
    for opts, ctc_in in (({"mask_encoder_padding": True}, None),
                         ({"ctc_weight": 0.5}, ctc)):
        other = port_searcher(tiny, **opts)
        other.set_decoder_prefix_tokens(5, 9)
        h, sc = other(enc, WAV_LENS, ctc_log_probs=ctc_in)
        assert h != jax_ctc[1][0] or not np.allclose(sc, jax_ctc[1][1])


def test_ctc_weight_zero_is_the_attention_search(tiny):
    enc, ctc = torch.from_numpy(tiny["enc"]), torch.from_numpy(tiny["ctc"])
    a, b = port_searcher(tiny), port_searcher(tiny, ctc_weight=0.0)
    for s in (a, b):
        s.set_decoder_prefix_tokens(5, 9)
    h_a, s_a = a(enc, WAV_LENS)
    h_b, s_b = b(enc, WAV_LENS, ctc_log_probs=ctc)
    assert h_a == h_b and torch.equal(s_a, s_b)


def test_mask_encoder_padding_is_batch_shape_invariant(tiny):
    """An utterance of 6 frames alone (length 5/6: frames 0..5 kept) and
    padded to 12 with noise frames beside another row (length 5/12), at
    the same 6-step budget: the same hypothesis and score."""
    rng = np.random.default_rng(4)
    alone = torch.from_numpy(tiny["enc"][1:, :6].copy())
    batch = torch.from_numpy(
        rng.standard_normal((2, 12, D)).astype(np.float32))
    batch[1, :6] = alone[0]
    s = port_searcher(tiny, mask_encoder_padding=True, max_decode_tokens=6)
    s.set_decoder_prefix_tokens(5, 9)
    h_a, s_a = s(alone, [5.0 / 6.0])
    h_b, s_b = s(batch, [1.0, 5.0 / 12.0])
    assert h_a[0] == h_b[1]
    np.testing.assert_allclose(s_a[0], s_b[1], atol=1e-5, rtol=0)


# ------------------------------------------------------- tiered decoding
TIER, CAP = 3, 8


@pytest.fixture(scope="module")
def jax_tier(tiny, tmp_path_factory):
    """The JAX search at the tier's budget (3 steps) certified against the
    cap's (8), as its tiered searcher runs it, on the eos-biased head
    (every row settles) and on the plain one (some row does not): tokens,
    lengths, scores and settled flags, one program for both heads (built
    once a run)."""
    return built_once(tmp_path_factory, "torch_search_options_tier",
                      lambda: _jax_tier(tiny))


def _jax_tier(tiny):
    rng = np.random.default_rng(9)
    enc = jnp.asarray(rng.standard_normal((3, 20, D)).astype(np.float32))
    biased = jax.tree_util.tree_map(lambda a: a, tiny["params"]["seq_lin"])
    biased["params"]["linear"]["bias"] = \
        biased["params"]["linear"]["bias"].at[2].add(12.0)
    s = jax_searcher(tiny, max_decode_tokens=CAP)
    out = {}
    for path, head in (("settled", biased),
                       ("rerun", tiny["params"]["seq_lin"])):
        s.bind(tiny["params"]["Transformer"], head)
        out[path] = [np.asarray(a) for a in jax_beam_search(
            s._decode_step_fn, s._init_cache_fn, s._params, enc,
            jnp.asarray([1, 5, 9], jnp.int32), TIER, s.config,
            s._cache_gather_fn, settled_bound_len=CAP,
            grow_cache_fn=s._grow_cache_fn, cache_growth=s.cache_growth)]
    return np.asarray(enc), out


@pytest.mark.parametrize("path", ["settled", "rerun"])
def test_decode_tier(tiny, jax_tier, path):
    """The tier pass equals JAX's (tokens, scores, settled flags); the
    tiered searcher returns it where every row settled and otherwise
    reruns the full budget; either way it equals the single pass."""
    enc, want = jax_tier
    head = tiny["head"]
    if path == "settled":
        head = P.LinearHead(D, VOCAB)
        head.load_state_dict(tiny["head"].state_dict())
        with torch.no_grad():
            head.linear.bias[2] += 12.0
    tiered = port_searcher(tiny, head, max_decode_tokens=CAP)
    tiered.decode_tier = TIER
    single = port_searcher(tiny, head, max_decode_tokens=CAP)
    enc = torch.from_numpy(enc.copy())
    prompt = torch.tensor([1, 5, 9])
    tokens, lengths, scores, settled = tiered.search(
        enc, prompt, max_steps=TIER, settled_bound_len=CAP)
    w_tokens, w_lengths, w_scores, w_settled = want[path]
    np.testing.assert_array_equal(settled.numpy(), w_settled)
    np.testing.assert_array_equal(lengths.numpy(), w_lengths)
    for row, n in enumerate(w_lengths):
        assert tokens[row, :n].tolist() == w_tokens[row, :n].tolist()
    np.testing.assert_allclose(scores.numpy(), w_scores, atol=ATOL, rtol=0)
    assert w_settled.all() == (path == "settled")
    for s in (tiered, single):
        s.set_decoder_prefix_tokens(5, 9)
    got = tiered(enc)
    assert tiered.last_tier_settled is (path == "settled")
    if path == "settled":
        assert got[0] == [tokens[r, :n].tolist()
                          for r, n in enumerate(lengths.tolist())]
    h, sc = single(enc)
    assert h == got[0] and torch.equal(sc, got[1])
    assert single.last_tier_settled is None


# ------------------------------------------------------------- prompts
def test_prompt_setters(tiny):
    s = port_searcher(tiny, source_lang=6, target_lang=7)
    assert (s.source_lang, s.target_lang) == (6, 7)
    assert port_searcher(tiny).source_lang == -100
    s.set_source_language(5)
    s.set_target_language(9)
    assert (s.source_lang, s.target_lang) == (5, 9)
    s.set_decoder_prefix_tokens(4, 3)
    assert s.decoder_input_tokens == [1, 4, 3]
    assert (s.source_lang, s.target_lang) == (4, 3)
