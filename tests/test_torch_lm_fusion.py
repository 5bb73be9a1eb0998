"""Shallow LM fusion in the port's searcher against the JAX package's.

On ``test_torch_search_options.py``'s tiny model, configuration and
tolerances: the stateless bigram LM of ``TestLMFusion`` and a stateful LM
(its state the token fed, reordered with the beam), each written once in
JAX and once in torch from the same numpy parameters, at weight 0.3
(``call_multi`` over two prompts and ``__call__``) and 5.0 (it steers
every hypothesis to its token); weight 0 with an LM set is the LM-free
search. Two JAX search programs, each run once for the module.
"""

import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_search_options import (  # noqa: E402,F401
    PROMPTS,
    VOCAB,
    _torch_threads,
    assert_same,
    jax_searcher,
    port_searcher,
    tiny,
)


def bigram(favored):
    """The bigram LM of ``TestLMFusion``: logits -5, +5 for ``favored``,
    whatever the tokens."""
    bias = np.full((VOCAB,), -5.0, np.float32)
    bias[favored] = 5.0
    zero = np.zeros((VOCAB, VOCAB), np.float32)
    return dict(bias=bias, cur=zero, prev=zero)


def stateful():
    """Logits that depend on the token fed and on the one before it, kept
    as the LM's state (B·beam rows, so the search reorders it)."""
    rng = np.random.default_rng(8)
    return dict(bias=np.zeros((VOCAB,), np.float32),
                cur=(1.5 * rng.standard_normal((VOCAB, VOCAB)))
                .astype(np.float32),
                prev=(1.5 * rng.standard_normal((VOCAB, VOCAB)))
                .astype(np.float32))


def lm_pair(np_params):
    """One LM, logits = bias + cur[token] + prev[state], state the token
    fed, written once in JAX and once in torch: ((step, init, params) in
    JAX, the same in torch), params from the same numpy arrays."""
    def j_step(p, tokens, position, state):
        return p["bias"][None, :] + p["cur"][tokens] + \
            p["prev"][state["prev"]], {"prev": tokens}

    def j_init(p, bb):
        return {"prev": jnp.zeros((bb,), jnp.int32)}

    def t_step(p, tokens, position, state):
        return p["bias"][None, :] + p["cur"][tokens] + \
            p["prev"][state["prev"]], {"prev": tokens}

    def t_init(p, bb):
        return {"prev": torch.zeros((bb,), dtype=torch.long)}

    return ((j_step, j_init, {k: jnp.asarray(v)
                              for k, v in np_params.items()}),
            (t_step, t_init, {k: torch.from_numpy(v)
                              for k, v in np_params.items()}))


@pytest.fixture(scope="module")
def jax_lm(tiny):
    """The JAX results: at weight 0.3, ``call_multi`` over both prompts
    with the bigram LM, then with the stateful one (one searcher: the LM's
    params are swapped in the dict it holds, so its program is reused); at
    weight 5.0, ``__call__`` under [1, 5, 9] with the bigram LM (favoring
    token 7)."""
    enc = jnp.asarray(tiny["enc"])
    (j_step, j_init, params), _ = lm_pair(bigram(11))
    s = jax_searcher(tiny)
    s.set_lm(j_step, j_init, params, lm_weight=0.3)
    s.bind(tiny["params"]["Transformer"], tiny["params"]["seq_lin"])
    out = {"bigram": s.call_multi(enc, prompts=PROMPTS)}
    params.update(lm_pair(stateful())[0][2])
    out["stateful"] = s.call_multi(enc, prompts=PROMPTS)
    (j_step, j_init, params), _ = lm_pair(bigram(7))
    s = jax_searcher(tiny)
    s.set_lm(j_step, j_init, params, lm_weight=5.0)
    s.bind(tiny["params"]["Transformer"], tiny["params"]["seq_lin"])
    s.set_decoder_prefix_tokens(5, 9)
    out["bigram_5.0"] = s(enc)
    return out


@pytest.mark.parametrize("name", ["bigram", "stateful"])
def test_lm_fusion_matches_jax(tiny, jax_lm, name):
    """Weight 0.3: ``call_multi`` and ``__call__`` equal to JAX."""
    s = port_searcher(tiny)
    s.set_lm(*lm_pair(bigram(11) if name == "bigram" else stateful())[1],
             lm_weight=0.3)
    enc = torch.from_numpy(tiny["enc"])
    want = jax_lm[name]
    for got, w in zip(s.call_multi(enc, prompts=PROMPTS), want):
        assert_same(got, w)
    s.set_decoder_prefix_tokens(5, 9)
    assert_same(s(enc), want[1])


def test_strong_lm_matches_jax_and_steers(tiny, jax_lm):
    """Weight 5.0: a +10-logit preference dominates the random model."""
    s = port_searcher(tiny)
    s.set_lm(*lm_pair(bigram(7))[1], lm_weight=5.0)
    s.set_decoder_prefix_tokens(5, 9)
    got = s(torch.from_numpy(tiny["enc"]))
    assert_same(got, jax_lm["bigram_5.0"])
    assert all(h and set(h) == {7} for h in got[0]), got[0]


def test_lm_weight_zero_is_the_lm_free_search(tiny):
    enc = torch.from_numpy(tiny["enc"])
    base = port_searcher(tiny)
    base.set_decoder_prefix_tokens(5, 9)
    want = base(enc)
    s = port_searcher(tiny, lm_weight=0.0)
    s.set_lm(*lm_pair(stateful())[1])  # weight stays 0: inactive
    s.set_decoder_prefix_tokens(5, 9)
    got = s(enc)
    assert got[0] == want[0] and torch.equal(got[1], want[1])
