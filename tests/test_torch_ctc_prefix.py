"""The port's CTC prefix scorer against the JAX package's.

``stac_st_tpu_torch.decoding.ctc_prefix`` (the kernel wrapper's plain
version on the CPU) against ``stac_st_tpu.decoding.ctc_prefix`` on
numpy-seeded posteriors (B 2 utterances x beam 3, T 13 frames, V 12), the
JAX functions jitted once: ``ctc_prefix_init``, ``ctc_prefix_score_all``
in partial mode (eos, blank and the last label among the candidates) and
full-vocabulary mode, on the empty prefix and on mid prefixes reached by a
sequence of scores and selects (one of them a repeated label), with
``input_lengths`` below T, and ``ctc_prefix_select``. Tolerance: fp32,
atol 1e-5 (the two sides take the same operations in the same order; exp,
log1p and the cumulative sum may differ by an ulp at magnitudes up to
about 50); entries at or below -1e8 (the -1e9 class, whose ulp is 64) are
compared as a class: the same places on both sides.

The wrapper's dispatch (plain version on CPU tensors, no count) and the
kernel on the card are checked in ``test_torch_ctc_prefix_kernel.py``
and by ``chip_smoke.py`` (phase ``search_options``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stac_st_tpu.decoding import ctc_prefix as J
from stac_st_tpu_torch.decoding import ctc_prefix as P

B, BEAM, T, V = 2, 3, 13, 12
BB = B * BEAM
BLANK, EOS = 0, 2
ATOL = 1e-5
NEG_CLASS = -1e8
LENS = np.asarray([13, 9, 13, 13, 5, 11], np.int64)  # per row, some < T

j_init = jax.jit(J.ctc_prefix_init)
j_score = jax.jit(J.ctc_prefix_score_all)
j_select = jax.jit(J.ctc_prefix_select)


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    neg = want <= NEG_CLASS
    np.testing.assert_array_equal(got <= NEG_CLASS, neg,
                                  err_msg=f"{what}: -1e9 class")
    np.testing.assert_allclose(got[~neg], want[~neg], atol=ATOL, rtol=0,
                               err_msg=what)


@pytest.fixture(scope="module")
def walk():
    """Posteriors (B, T, V) and a walk of four scores and selects in JAX
    from the empty prefix (candidates: eos, blank, the last label, one
    more), each step's JAX inputs and outputs kept; step 2 commits the
    last label again (a repeated label)."""
    rng = np.random.default_rng(11)
    lp = _log_softmax(2.0 * rng.standard_normal((B, T, V)))
    lp_rep = jnp.asarray(np.repeat(lp, BEAM, axis=0))
    state = j_init(lp_rep)
    steps = []
    for i in range(4):
        cand = rng.integers(3, V, (BB, 4))
        cand[:, 0], cand[:, 1] = EOS, BLANK
        cand[:, 2] = np.where(np.asarray(state.last) >= 0,
                              np.asarray(state.last), 5)
        out = j_score(state, lp_rep, jnp.asarray(LENS), BLANK, EOS,
                      jnp.asarray(cand))
        k = np.full((BB,), 2 if i == 2 else 3)
        steps.append(dict(state=state, cand=cand, out=out, k=k))
        state = j_select(out[1], out[2], jnp.asarray(k))
    return lp, lp_rep, steps


def _port_state(state):
    return P.CtcPrefixState(*(torch.from_numpy(np.asarray(a).copy())
                              for a in state))


def test_init_matches_jax(walk):
    lp, _, steps = walk
    want = steps[0]["state"]
    got = P.ctc_prefix_init(torch.from_numpy(lp), BLANK, BEAM)
    for g, w, name in zip(got, want, ("r_nb", "r_b", "last")):
        assert_close(g, w, name)


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_partial_scores_match_jax(walk, step):
    """Step 0 is the empty prefix; 1-3 mid prefixes (3 after a repeated
    label), each from the JAX state."""
    lp, _, steps = walk
    s = steps[step]
    scores, cstate, cand = P.ctc_prefix_score_all(
        _port_state(s["state"]), torch.from_numpy(lp),
        torch.from_numpy(LENS), BLANK, EOS,
        candidates=torch.from_numpy(s["cand"]), beam=BEAM)
    w_scores, w_state, w_cand = s["out"]
    assert_close(scores, w_scores, "scores")
    assert_close(cstate.r_nb, w_state.r_nb, "r_nb")
    assert_close(cstate.r_b, w_state.r_b, "r_b")
    np.testing.assert_array_equal(cand.numpy(), np.asarray(w_cand))
    # the overrides: eos scores the complete prefix, blank -1e9
    assert (scores[:, 1] == P.NEG_INF).all()
    assert (scores[:, 0] > NEG_CLASS).any()


@pytest.mark.parametrize("step", [0, 2])
def test_full_vocabulary_scores_match_jax(walk, step):
    lp, lp_rep, steps = walk
    state = steps[step]["state"]
    w_scores, w_state, w_cand = j_score(state, lp_rep, jnp.asarray(LENS),
                                        BLANK, EOS)
    scores, cstate, cand = P.ctc_prefix_score_all(
        _port_state(state), torch.from_numpy(lp), torch.from_numpy(LENS),
        BLANK, EOS, beam=BEAM)
    assert scores.shape == (BB, V)
    assert_close(scores, w_scores, "scores")
    assert_close(cstate.r_nb, w_state.r_nb, "r_nb")
    assert_close(cstate.r_b, w_state.r_b, "r_b")
    np.testing.assert_array_equal(cand.numpy(), np.asarray(w_cand))


def test_select_matches_jax_and_commits_by_parent(walk):
    lp, _, steps = walk
    s = steps[1]
    _, cstate, cand = P.ctc_prefix_score_all(
        _port_state(s["state"]), torch.from_numpy(lp),
        torch.from_numpy(LENS), BLANK, EOS,
        candidates=torch.from_numpy(s["cand"]), beam=BEAM)
    k = torch.from_numpy(s["k"])
    got = P.ctc_prefix_select(cstate, cand, k)
    want = steps[2]["state"]
    for g, w, name in zip(got, want, ("r_nb", "r_b", "last")):
        assert_close(g, w, name)
    # ``rows``: row i commits a candidate of row rows[i] (the search's
    # parent), as a gather of the candidate state by rows, then a select
    rows = torch.tensor([2, 0, 0, 5, 3, 3])
    by_rows = P.ctc_prefix_select(cstate, cand, k, rows=rows)
    gathered = P.CtcPrefixState(cstate.r_nb[rows], cstate.r_b[rows],
                                cstate.last[rows])
    for g, w in zip(by_rows, P.ctc_prefix_select(gathered, cand[rows], k)):
        assert torch.equal(g, w)
