"""Decoding and training the alternate encoders' models, port vs JAX.

The models of ``test_torch_encoders.py`` (tiny sizes, fp32, CPU):

* the beam search (serving configuration, beam 3, eos's bias shifted)
  over the post-LN model and over the relpos Conformer: the port's
  ``MultiTaskBeamSearch`` and the JAX package's on the same encoder
  output (the port's ``encode``, which ``test_torch_encoders.py`` holds
  to JAX's), one jitted JAX search program a model; hypotheses equal,
  scores within 1e-4;
* the post-LN decoder's every step form against the port's own
  full-prefix ``decode`` of each row's history (which the forward test
  holds to JAX's): beam 1, anc mode under a random ancestry, gather mode
  (the beam-1 layout at B·beam rows reordered by ``gather_rows``; a float
  cache at 1e-4 and the int8 cache within its quantization error), the
  ragged step of the slot loop (rows rewound to their own indices) and
  the window of speculative decoding;
* one train step of the relpos Conformer (dropout 0, CTC 0.3, label
  smoothing 0.1), the JAX loss and gradients (one jitted
  ``value_and_grad`` of the JAX step's forward and objectives) against
  the port's ``loss_and_grad``: loss rtol 2e-5 and gradients atol
  2e-5 x the largest with rtol 2e-3, ``tests/test_torch_train_step.py``'s
  tolerances; at dropout 0.1 the port's gradients with ``remat`` equal
  those without within 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.decoding.beam_search import MultiTaskBeamSearch as JaxSearch
from stac_st_tpu.ops import Fbank as JFbank
from stac_st_tpu.ops.cmvn import CmvnState as JCmvn
from stac_st_tpu.training import step as jstep
from stac_st_tpu_torch.decoding.beam_search import (
    MultiTaskBeamSearch,
    gather_rows,
)
from stac_st_tpu_torch.ops.cmvn import CmvnState
from stac_st_tpu_torch.ops.fbank import Fbank
from stac_st_tpu_torch.training import step as pstep

from test_torch_encoders import (
    D,
    MODELS,
    VOCAB,
    build_jax,
    build_port,
)

ATOL = 1e-4
# one int8 step of every K/V value (max |row| / 127), through the
# attention average and three post-LN layer norms a layer
INT8_ATOL = 5e-2
OPTS = dict(bos_index=1, eos_index=2, blank_index=0, min_decode_ratio=0.0,
            max_decode_ratio=1.0, beam_size=3, using_eos_threshold=True,
            eos_threshold=1.5, length_normalization=True, temperature=1.15)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# eos's bias moved so that, on this file's encoder output, one search
# stops early and the other runs its 11-step budget
EOS_SHIFT = {"post_ln": -0.7, "conformer_relpos": 0.9}


@pytest.fixture(scope="module")
def models():
    """The post-LN model and the relpos Conformer, eos's bias shifted."""
    out = {}
    for seed, (name, shift) in enumerate(EOS_SHIFT.items()):
        jx = build_jax(MODELS[name], seed=seed)
        jx["params"]["seq_lin"]["params"]["linear"]["bias"][2] += shift
        out[name] = (jx, build_port(jx, MODELS[name]))
    return out


def _encoded(pt, seed=5):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal((2, 41, 80))
                             .astype(np.float32))
    lens = torch.tensor([1.0, 0.75])
    with torch.no_grad():
        return pt["transformer"].encode(pt["cnn"](feats), lens), lens


@pytest.mark.parametrize("name", ["post_ln", "conformer_relpos"])
def test_beam_search_matches_jax(models, name):
    jx, pt = models[name]
    enc, lens = _encoded(pt)
    js = JaxSearch([jx["transformer"], jx["seq_lin"], None], **OPTS)
    params = jax.tree_util.tree_map(jnp.asarray, jx["params"])
    js.bind(params["Transformer"], params["seq_lin"])
    ps = MultiTaskBeamSearch(pt["transformer"], pt["seq_lin"], **OPTS)
    for s in (js, ps):
        s.set_decoder_prefix_tokens(5, 9)
    w_hyps, w_scores = js(enc.numpy(), lens.numpy())
    with torch.no_grad():
        g_hyps, g_scores = ps(enc, lens)
    assert g_hyps == w_hyps
    np.testing.assert_allclose(np.asarray(g_scores), np.asarray(w_scores),
                               atol=ATOL, rtol=0)
    assert len({len(h) for h in g_hyps}) > 1


# ------------------------------------------- the post-LN decoder's steps
def _oracle(model, hist, enc):
    """The full-prefix decode of each row's history (R, T): (R, T, d)."""
    return model.decode(torch.from_numpy(hist), enc)


def _ancestry(rng, hist, B, beam):
    parent = rng.integers(0, beam, (B, beam))
    return parent, np.take_along_axis(hist, parent[:, :, None], axis=1)


@pytest.mark.parametrize("form", ["beam1", "anc", "gather", "ragged",
                                  "window"])
def test_post_ln_decode_steps_equal_full_prefix_decode(models, form):
    """Hidden states of every step of each form equal the oracle decode's
    last positions (fp32, atol 1e-4; int8 cache within INT8_ATOL)."""
    _, pt = models["post_ln"]
    model = pt["transformer"]
    assert not model.normalize_before
    enc, _ = _encoded(pt)
    B, steps = enc.shape[0], 6
    rng = np.random.default_rng({"beam1": 1, "anc": 2, "gather": 3,
                                 "ragged": 4, "window": 5}[form])
    torch.set_grad_enabled(False)
    try:
        if form in ("beam1", "window"):
            toks = rng.integers(3, VOCAB, (B, steps))
            want = _oracle(model, toks, enc)
            cache = model.init_decode_cache(enc, steps)
            if form == "beam1":
                got = torch.stack([model.decode_step(
                    torch.from_numpy(toks[:, p]), p, cache)
                    for p in range(steps)], 1)
            else:  # a 2-token prefix, then a window of 4 over it
                model.decode_window(torch.from_numpy(toks[:, :2]), 0, cache)
                got = torch.cat([want[:, :2], model.decode_window(
                    torch.from_numpy(toks[:, 2:]), 2, cache)], 1)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                       rtol=0)
        elif form == "ragged":
            _ragged(model, enc, rng)
        else:
            caches = ([None, "int8"] if form == "gather" else [None])
            for dtype in caches:
                _beam_steps(model, enc, np.random.default_rng(7), form,
                            dtype, steps)
    finally:
        torch.set_grad_enabled(True)


def _beam_steps(model, enc, rng, form, cache_dtype, steps, beam=3):
    """anc mode, or gather mode with a float or int8 cache, under one
    random ancestry; each step against the oracle of every hypothesis's
    reconstructed prefix."""
    B = enc.shape[0]
    anc = form == "anc"
    cache = model.init_decode_cache(enc, steps, None, beam, anc_mode=anc,
                                    cache_dtype=cache_dtype)
    hist = np.zeros((B, beam, 0), np.int64)
    rep = enc.repeat_interleave(beam, dim=0)
    for p in range(steps):
        if p:
            parent, hist = _ancestry(rng, hist, B, beam)
            if anc:
                par = torch.from_numpy(parent)
                cache["anc"] = torch.gather(
                    cache["anc"], 1, par[:, :, None].expand(-1, -1, steps))
                cache["anc"][:, :, p] = torch.arange(beam, dtype=torch.int32)
            else:
                flat = (np.arange(B)[:, None] * beam + parent).reshape(-1)
                gather_rows(cache, torch.from_numpy(flat))
        tok = rng.integers(3, VOCAB, (B, beam))
        hist = np.concatenate([hist, tok[:, :, None]], axis=2)
        h = model.decode_step(torch.from_numpy(tok.reshape(-1)), p, cache)
        want = _oracle(model, hist.reshape(B * beam, p + 1), rep)[:, -1]
        np.testing.assert_allclose(
            h.numpy(), want.numpy(), rtol=0, err_msg=f"{form} step {p}",
            atol=INT8_ATOL if cache_dtype else ATOL)


def _ragged(model, enc, rng):
    """Four rows decoded 4 positions together, then rewound to their own
    indices 0, 2, 3 and 4 and stepped twice more at per-row positions
    (``decode_step_rows``, every layer's index a (R,) tensor)."""
    R = 4
    enc = enc.repeat(2, 1, 1)
    toks = rng.integers(3, VOCAB, (R, 4))
    cache = model.init_decode_cache(enc, 8)
    for p in range(4):
        model.decode_step(torch.from_numpy(toks[:, p]), p, cache)
    idx = np.asarray([0, 2, 3, 4])
    for layer in cache["layers"]:
        layer["self"]["index"] = torch.from_numpy(idx.astype(np.int32))
    hist = [list(toks[r, :idx[r]]) for r in range(R)]
    for step in range(2):
        new = rng.integers(3, VOCAB, R)
        h = model.decode_step_rows(torch.from_numpy(new),
                                   torch.from_numpy(idx + step), cache)
        for r in range(R):
            hist[r].append(int(new[r]))
            want = _oracle(model, np.asarray([hist[r]]), enc[r:r + 1])
            np.testing.assert_allclose(h[r].numpy(), want[0, -1].numpy(),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"row {r} step {step}")


# ----------------------------------------------------- one train step
def _train_batch(rng, B=2, samples=8000, U=8):
    sig = (0.1 * rng.standard_normal((B, samples))).astype(np.float32)
    n_tok = np.asarray([6, 4])
    tokens, bos, eos = (np.zeros((B, U), np.int32) for _ in range(3))
    for b in range(B):
        seq = rng.integers(3, VOCAB, n_tok[b])
        tokens[b, :n_tok[b]] = seq
        bos[b, 0], bos[b, 1:n_tok[b] + 1] = 1, seq
        eos[b, :n_tok[b]], eos[b, n_tok[b]] = seq, 2
    return {"sig": sig, "sig_len": np.asarray([1.0, 0.8], np.float32),
            "tokens": tokens, "tokens_len": (n_tok / U).astype(np.float32),
            "tokens_bos": bos, "tokens_eos": eos,
            "tokens_eos_len": ((n_tok + 1) / U).astype(np.float32)}


def _step_cfg(package, fbank, mods):
    return package.StepConfig(
        fbank=fbank, cnn=mods["cnn"], transformer=mods["transformer"],
        seq_lin=mods["seq_lin"], ctc_lin=mods["ctc_lin"], specaug_opts=None,
        ctc_weight=0.3, label_smoothing=0.1, loss_reduction="batchmean",
        pad_index=0, blank_index=0)


def test_relpos_conformer_train_step_matches_jax(models):
    jx, _ = models["conformer_relpos"]
    rng = np.random.default_rng(8)
    batch = _train_batch(rng)
    mean = rng.standard_normal(80).astype(np.float32)
    std = (0.5 + rng.random(80)).astype(np.float32)
    cfg_j = _step_cfg(jstep, JFbank(), jx)
    cmvn_j = JCmvn(jnp.asarray(mean), jnp.asarray(std),
                   jnp.asarray(10.0, jnp.float32))

    @jax.jit
    def loss_and_grad(params, batch):
        def loss_fn(p):
            p_ctc, p_seq, _, _ = jstep._forward(p, cmvn_j, batch, cfg_j,
                                                True, False,
                                                jax.random.PRNGKey(0))
            return jstep._objectives(p_ctc, p_seq, batch, cfg_j)[0]

        return jax.value_and_grad(loss_fn)(params)

    params = jax.tree_util.tree_map(jnp.asarray, jx["params"])
    loss_j, grad_j = loss_and_grad(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    # the JAX gradients in the port's naming, through a model loaded the
    # strict way
    want = build_port(dict(jx, params=jax.tree_util.tree_map(
        np.asarray, grad_j)), MODELS["conformer_relpos"])
    want = {f"{key}.{n}": p.detach() for key, m in zip(
        pstep.MODULE_KEYS, (want["cnn"], want["transformer"],
                            want["seq_lin"], want["ctc_lin"]))
            for n, p in m.named_parameters()}
    pbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}

    def port_grad(remat=False, dropout=0.0):
        mods = build_port(jx, {**MODELS["conformer_relpos"], "remat": remat},
                          dropout=dropout)
        cfg_p = _step_cfg(pstep, Fbank(), mods)
        state = pstep.init_train_state(cfg_p, None, "cpu")
        state.cmvn = CmvnState(torch.from_numpy(mean), torch.from_numpy(std),
                               torch.tensor(10.0))
        metrics, grad, _ = pstep.loss_and_grad(cfg_p, state, pbatch, 3)
        return float(metrics["loss"]), state.params.named(grad)

    loss_p, got = port_grad()
    np.testing.assert_allclose(loss_p, float(loss_j), rtol=2e-5)
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=2e-3, atol=2e-5 * scale,
                                   err_msg=name)
    # remat replays the step's dropout draws: gradients at dropout 0.1
    # with and without it
    base, again = port_grad(dropout=0.1)[1], port_grad(True, 0.1)[1]
    for name, g in base.items():
        np.testing.assert_allclose(again[name].detach().numpy(),
                                   g.detach().numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
