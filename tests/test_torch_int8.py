"""The port's int8 decode and speculative decoding against the JAX package.

On the tiny fixture (d32, 4 heads, 2 + 2 layers, vocab 150), fp32 on the
CPU, inputs from numpy seeds, each JAX reference built once for the module
(Pallas off: the JAX searcher runs its gather mode, as it does with the
int8 cache on its XLA path):

* ``quantize_decode_weights``: the port's quantized modules, exported with
  ``to_jax_params``, against the reference's tree: the same leaves, int8
  values equal but for ±1 at no more than 0.1 % of entries (a division at
  a rounding tie), scales within rtol 1e-6; the JAX tree loaded into the
  port comes back out unchanged;
* one decode step at a time against JAX's ``decode_step``: logits within
  atol 1e-4, int8 caches and scales as above, for int8 weights, the int8
  cache at beam 1 (in-place append) and beam 3 (after a gather), and the
  ragged ``decode_step_rows``;
* the searcher in gather mode with the int8 cache (beam 4, beam 1, with
  segmented growth, ``call_multi``): hyps equal, scores within rtol 1e-5;
* ``STEngine(weights_int8=True, kv_cache_dtype='int8')``: the JAX engine's
  texts, on the JAX engine's own quantized weights;
* the slot loop on that engine: the port's sequential greedy decode;
* ``speculative_greedy_search``: tokens, length and target steps equal to
  JAX's, float and int8 caches, and int8 weights.

The int8 kernels' card checks are in ``test_torch_decode_attention.py``.
"""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.decoding import speculative as jax_spec
from stac_st_tpu.decoding.beam_search import (
    MultiTaskBeamSearch as JaxSearcher,
)
from stac_st_tpu.utils.quantize import (
    quantize_decode_weights as jax_quantize,
)
from stac_st_tpu_torch.decoding import speculative as spec
from stac_st_tpu_torch.decoding.beam_search import (
    MultiTaskBeamSearch,
    gather_rows,
)
from stac_st_tpu_torch.interop.from_jax import load_jax_params, to_jax_params
from stac_st_tpu_torch.utils.quantize import (
    Int8Linear,
    quantize_decode_weights,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import (  # noqa: E402
    ATOL,
    D,
    VOCAB,
    build_jax_tiny,
    build_port_twin,
)
from torch_once import built_once  # noqa: E402

SEARCH = dict(bos_index=1, eos_index=2, blank_index=0,
              min_decode_ratio=0.0, max_decode_ratio=1.0,
              using_eos_threshold=True, length_normalization=True,
              temperature=1.15)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny model (eos made competitive, so searches end early
    and late), its quantized tree, and two port twins: float, and
    quantized holding the JAX tree's int8 values."""
    jx = build_jax_tiny(seed=4)
    seq = jx["params"]["seq_lin"]["params"]["linear"]
    seq["bias"] = seq["bias"].at[2].add(0.4)
    t_q, s_q = jax.jit(jax_quantize)(jx["params"]["Transformer"],
                                     jx["params"]["seq_lin"])
    jq = {**jx["params"], "Transformer": t_q, "seq_lin": s_q}
    pt = build_port_twin(jx)
    pq = build_port_twin(jx)
    quantize_decode_weights(pq["transformer"], pq["seq_lin"])
    load_jax_params(_np_tree(jq), **pq, settings=jx["transformer"])
    for m in (*pt.values(), *pq.values()):
        m.eval()
    return jx, jq, pt, pq


# ------------------------------------------------------------ quantization
def test_quantized_trees_equal_jax(tiny):
    jx, jq, _, pq = tiny
    own = build_port_twin(jx)
    quantize_decode_weights(own["transformer"], own["seq_lin"])
    got = _flat(to_jax_params(**own))
    want = _flat(_np_tree(jq))
    assert sorted(got) == sorted(want)  # the same leaves quantized
    n_int8 = 0
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype, key
        if w.dtype == np.int8:
            n_int8 += 1
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, key
        elif key.endswith("kernel_scale"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)
    # per decoder layer: self q/k/v/out, cross q/out, fc1/fc2; seq_lin
    assert n_int8 == 2 * 8 + 1
    # the JAX tree, loaded into quantized port modules, comes back out
    back = _flat(to_jax_params(**pq))
    for key, w in want.items():
        np.testing.assert_array_equal(back[key], w, err_msg=key)
    # the scales stay fp32 through a later cast; the float paths refuse
    lin = own["seq_lin"].linear
    assert isinstance(lin, Int8Linear)
    own["seq_lin"].to(torch.bfloat16)
    assert lin.scale.dtype == torch.float32
    assert lin.weight.dtype == torch.int8 and lin.bias.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="decode path only"):
        own["transformer"](torch.zeros(1, 9, 320), torch.ones(1, 3).long())


# ------------------------------------------------------------ decode steps
@jax.jit
def _jax_gather(cache, flat):
    layers = []
    for layer in cache["layers"]:
        sc = layer["self"]
        layers.append({**layer, "self": {
            n: (x if n == "index" else jnp.take(x, flat, axis=0))
            for n, x in sc.items()}})
    return {**cache, "layers": layers}


def _assert_int8_close(got, want, what):
    got = np.asarray(got).astype(np.int32)
    diff = np.abs(got - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, what


_INT8_LEAVES = ("k", "v", "k_scale", "v_scale")


def _sync_and_check(cj, cp, count):
    """Hold the port's int8 caches to JAX's (values within ±1, scales
    within rtol 1e-6), then give the port JAX's exact caches, so the next
    step starts from the same cache. Adds the int8 entries compared and
    those that differ to ``count``; returns the rows whose new K/V differ
    (a projection that rounds one ulp apart can put x/s on the other side
    of a .5 and move its int8 value by one)."""
    flipped = np.zeros(cp["layers"][0]["self"]["k"].shape[0], bool)
    for lj, lp in zip(cj["layers"], cp["layers"]):
        pairs = [(lp["self"], lj["self"], n) for n in _INT8_LEAVES]
        pairs += [(lp, lj, n) for n in ("cross_k", "cross_v",
                                        "cross_k_scale", "cross_v_scale")]
        for port, ref, name in pairs:
            want = np.array(ref[name])
            got = port[name].numpy()
            if want.dtype == np.int8:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, name
                count["entries"] += diff.size
                count["differ"] += int((diff > 0).sum())
                if "cross" not in name:
                    flipped |= (diff > 0).reshape(len(got), -1).any(axis=1)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=name)
            port[name].copy_(torch.from_numpy(want))
    return flipped


@pytest.mark.parametrize("case", ["weights", "cache_beam1", "cache_beam3",
                                  "rows"])
def test_decode_step_matches_jax(tiny, case):
    """Logits of each step against JAX's decode_step (decode_step_rows for
    ``rows``: four slots at indices 2, 5, 7 and 10 of an 8-position int8
    cache, the last past it), each step from the same cache; beam 3
    gathers the caches by random parents before each step. A row whose
    new int8 K/V differ from JAX's by a rounding tie is held to 1e-2 (one
    int8 step of one value), every other row to atol 1e-4."""
    jx, jq, pt, pq = tiny
    t = jx["transformer"]
    weights = case == "weights"
    params, mods = (jq, pq) if weights else (jx["params"], pt)
    kv = None if weights else "int8"
    beam = 3 if case == "cache_beam3" else 1
    rng = np.random.default_rng(17)
    B = 4 if case == "rows" else 2
    enc = rng.standard_normal((B, 11, D)).astype(np.float32)
    steps = 3
    cap = 8 if case == "rows" else steps
    cj = jax.jit(lambda tp, e: t.apply(tp, e, cap, None, beam, False, kv,
                                       method=t.init_decode_cache))(
        params["Transformer"], jnp.asarray(enc))
    model = mods["transformer"]
    cp = model.init_decode_cache(torch.from_numpy(enc), cap, None, beam,
                                 cache_dtype=kv)
    if case == "rows":  # random int8 history, one index per slot
        idx = np.asarray([2, 5, 7, 10], np.int32)
        for lj, lp in zip(cj["layers"], cp["layers"]):
            new = {"index": jnp.asarray(idx.reshape(B, 1, 1, 1))}
            for name in _INT8_LEAVES:
                shape = lp["self"][name].shape
                x = (rng.integers(-127, 128, shape).astype(np.int8)
                     if name in ("k", "v")
                     else (0.01 + rng.random(shape)).astype(np.float32))
                new[name] = jnp.asarray(x)
                lp["self"][name].copy_(torch.from_numpy(x))
            lj["self"] = new
            lp["self"]["index"] = torch.from_numpy(idx)
    head = jx["seq_lin"]
    method = t.decode_step_rows if case == "rows" else t.decode_step
    step_j = jax.jit(lambda tok, pos, c: t.apply(params["Transformer"], tok,
                                                 pos, c, method=method))
    head_j = jax.jit(lambda h: head.apply(params["seq_lin"], h))
    flipped = np.zeros(B * beam, bool)
    count = {"entries": 0, "differ": 0}
    with torch.no_grad():
        for p in range(steps):
            tok = rng.integers(3, VOCAB, B * beam)
            if kv == "int8":
                _sync_and_check(cj, cp, count)
            if p and beam > 1:
                flat = (np.arange(B)[:, None] * beam
                        + rng.integers(0, beam, (B, beam))).reshape(-1)
                cj = _jax_gather(cj, jnp.asarray(flat))
                gather_rows(cp, torch.from_numpy(flat))
            if case == "rows":
                pos = idx + p
                hj, cj = step_j(jnp.asarray(tok), jnp.asarray(pos), cj)
                hp = model.decode_step_rows(torch.from_numpy(tok),
                                            torch.from_numpy(pos), cp)
            else:
                hj, cj = step_j(jnp.asarray(tok), jnp.asarray(p, jnp.int32),
                                cj)
                hp = model.decode_step(torch.from_numpy(tok), p, cp)
            got = mods["seq_lin"](hp).numpy()
            want = np.asarray(head_j(hj))
            tie = (_sync_and_check(cj, cp, count) if kv == "int8"
                   else np.zeros(len(got), bool))
            flipped |= tie
            np.testing.assert_allclose(got[~tie], want[~tie], atol=ATOL,
                                       rtol=0, err_msg=f"{case} step {p}")
            np.testing.assert_allclose(got[tie], want[tie], atol=1e-2,
                                       rtol=0, err_msg=f"{case} step {p}")
    # ties are rare: at most 0.1 % of the int8 entries, one row
    assert count["differ"] <= 1e-3 * count["entries"] and flipped.sum() <= 1


# ---------------------------------------------------------------- searcher
@pytest.fixture(scope="module")
def jax_int8_searches(tiny, tmp_path_factory):
    """The JAX searcher with the int8 cache, beam 4 and beam 1, under two
    prompts, on one seeded encoder output (built once a run)."""
    return built_once(tmp_path_factory, "torch_int8_searches",
                      lambda: _jax_int8_searches(tiny))


def _jax_int8_searches(tiny):
    jx, _, _, _ = tiny
    enc = np.random.default_rng(5).standard_normal((2, 12, D)) \
        .astype(np.float32)
    out = {}
    for beam in (4, 1):
        s = JaxSearcher([jx["transformer"], jx["seq_lin"], None],
                        beam_size=beam, kv_cache_dtype="int8", **SEARCH)
        s.bind(jx["params"]["Transformer"], jx["params"]["seq_lin"])
        for prompt in ((5, 6), (5, 9)):
            s.set_decoder_prefix_tokens(*prompt)
            hyps, scores = s(jnp.asarray(enc))
            out[beam, prompt] = hyps, np.asarray(scores)
    return enc, out


@pytest.mark.parametrize("beam,growth", [(4, None), (4, 4), (1, 4)])
def test_int8_search_matches_jax(tiny, jax_int8_searches, beam, growth):
    _, _, pt, _ = tiny
    enc, want = jax_int8_searches
    s = MultiTaskBeamSearch(pt["transformer"], pt["seq_lin"],
                            beam_size=beam, kv_cache_dtype="int8",
                            cache_growth=growth, **SEARCH)
    s.set_decoder_prefix_tokens(5, 6)
    hyps, scores = s(torch.from_numpy(enc))
    w_hyps, w_scores = want[beam, (5, 6)]
    assert hyps == w_hyps
    assert len({len(h) for h in hyps}) > 1 or beam == 1
    np.testing.assert_allclose(scores.numpy(), w_scores, rtol=1e-5)


def test_int8_call_multi_with_growth_matches_jax(tiny, jax_int8_searches):
    _, _, pt, _ = tiny
    enc, want = jax_int8_searches
    s = MultiTaskBeamSearch(pt["transformer"], pt["seq_lin"], beam_size=4,
                            kv_cache_dtype="int8", cache_growth=4, **SEARCH)
    fused = s.call_multi(torch.from_numpy(enc),
                         prompts=[[1, 5, 6], [1, 5, 9]])
    for (hyps, scores), prompt in zip(fused, ((5, 6), (5, 9))):
        w_hyps, w_scores = want[4, prompt]
        assert hyps == w_hyps
        np.testing.assert_allclose(scores.numpy(), w_scores, rtol=1e-5)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        MultiTaskBeamSearch(pt["transformer"], pt["seq_lin"],
                            kv_cache_dtype="fp8")


# ------------------------------------------------------ engine, slot loop
@pytest.fixture(scope="module")
def engines(tiny, tmp_path_factory):
    """The JAX and the port STEngine with int8 weights and the int8 cache
    (beam 3, one 0.5 s bucket, fp32), the port's holding the JAX engine's
    quantized weights; seeded requests."""
    from fixtures import make_corpus, train_fixture_tokenizer
    from stac_st_tpu.ops.cmvn import cmvn_init as jax_cmvn_init
    from stac_st_tpu.serving import STEngine as JaxEngine
    from stac_st_tpu_torch.ops.cmvn import cmvn_init
    from stac_st_tpu_torch.serving import STEngine

    jx, _, _, _ = tiny
    root = str(tmp_path_factory.mktemp("torch_int8"))
    _, _, joint = make_corpus(root, n_utts=4, seconds=0.4)
    sp, _ = train_fixture_tokenizer(root, joint, vocab=150)
    opts = dict(beam_size=3, bucket_seconds=(0.5,), bf16=False,
                max_decode_tokens=8, weights_int8=True,
                kv_cache_dtype="int8")
    jax_engine = JaxEngine(jx["transformer"], jx["cnn"], jx["seq_lin"], None,
                           jx["params"], jax_cmvn_init(80), sp, **opts)
    mods = build_port_twin(jx)
    port = STEngine(mods["transformer"], mods["cnn"], mods["seq_lin"], None,
                    cmvn_init(80), sp, device="cpu", **opts)
    load_jax_params(
        _np_tree({k: jax_engine.params[k] for k in ("Transformer",
                                                    "seq_lin")}),
        transformer=port._transformer, seq_lin=port.searcher.seq_lin,
        settings=jx["transformer"])
    rng = np.random.default_rng(8)
    wavs = [((0.2 + 0.2 * i) * rng.standard_normal(8000)).astype(np.float32)
            for i in range(4)]
    return jax_engine, port, wavs


def test_int8_engine_matches_jax(engines):
    jax_engine, port, wavs = engines
    assert port.weights_int8 and port.searcher.kv_cache_dtype == "int8"
    out = port.translate(wavs)
    assert out == jax_engine.translate(wavs) and any(out)
    assert port.transcribe(wavs) == jax_engine.transcribe(wavs)


def _greedy(eng, S_max, cap, wav):
    """One utterance alone, as the slot loop admits it (padded to S_max,
    masked past floor(len · S_w), the prompt through decode_window), then
    scalar decode steps: its text."""
    from stac_st_tpu_torch.serving_continuous import _PROMPT_LEN

    model = eng._transformer
    with torch.inference_mode():
        enc = eng._encode(torch.from_numpy(wav[None]), torch.ones(1))
        S_w = enc.shape[1]
        bias = torch.where(torch.arange(S_max)[None, :] > S_w, -1e9, 0.0)
        enc = torch.nn.functional.pad(enc, (0, 0, 0, S_max - S_w))
        cache = model.init_decode_cache(enc, _PROMPT_LEN + cap, bias,
                                        cache_dtype="int8")
        hidden = model.decode_window(
            torch.tensor([eng._prompt("es", "en")]), 0, cache)
        tok = int(torch.argmax(eng.searcher.seq_lin(hidden[:, -1])))
        out, budget = [], min(S_w + 1, cap)
        while tok != 2 and len(out) < budget:
            out.append(tok)
            if len(out) >= budget:
                break
            hidden = model.decode_step(torch.tensor([tok]),
                                       _PROMPT_LEN + len(out) - 1, cache)
            tok = int(torch.argmax(eng.searcher.seq_lin(hidden)))
    return eng.tokenizer.decode_ids(out)


def test_int8_slot_loop_equals_sequential_greedy(engines):
    from stac_st_tpu_torch.serving_continuous import ContinuousBatchingEngine

    _, port, wavs = engines
    cont = ContinuousBatchingEngine(port, slots=3, chunk=4,
                                    admit_rungs=(1, 3))
    try:
        got = [f.result(timeout=120)
               for f in [cont.submit(w) for w in wavs]]
        S_max, cap = cont._S_max, cont.cap
    finally:
        cont.close()
    assert got == [_greedy(port, S_max, cap, w) for w in wavs]


# ------------------------------------------------------ speculative decoding
@pytest.fixture(scope="module")
def draft():
    """The draft: a second tiny model of other seeded weights, in JAX and
    in the port, built once."""
    dj = build_jax_tiny(seed=9)
    return dj, build_port_twin(dj)


@pytest.mark.parametrize("kv,int8_weights", [(None, False), ("int8", False),
                                             ("int8", True)])
def test_speculative_matches_jax(tiny, draft, kv, int8_weights):
    """Target: the tiny model; draft: a second tiny model of other seeded
    weights; k = 3, a 9-step budget. The JAX reference runs jitted, as the
    JAX engine runs it."""
    jx, jq, pt, pq = tiny
    dj, dp = draft
    params, mods = (jq, pq) if int8_weights else (jx["params"], pt)
    rng = np.random.default_rng(12)
    enc_t, enc_d = (rng.standard_normal((1, 11, D)).astype(np.float32)
                    for _ in range(2))
    prompt = np.asarray([1, 5, 6], np.int32)

    @jax.jit
    def reference(tp, dp_, enc_t, enc_d, prompt):
        return jax_spec.speculative_greedy_search(
            jax_spec.bind_spec_model(jx["transformer"], jx["seq_lin"],
                                     tp["Transformer"], tp["seq_lin"], kv),
            jax_spec.bind_spec_model(dj["transformer"], dj["seq_lin"],
                                     dp_["Transformer"], dp_["seq_lin"], kv),
            enc_t, enc_d, prompt, 9, k=3)

    want = reference(params, dj["params"], jnp.asarray(enc_t),
                     jnp.asarray(enc_d), jnp.asarray(prompt))
    with torch.no_grad():
        got = spec.speculative_greedy_search(
            spec.bind_spec_model(mods["transformer"], mods["seq_lin"], kv),
            spec.bind_spec_model(dp["transformer"].eval(), dp["seq_lin"],
                                 kv),
            torch.from_numpy(enc_t), torch.from_numpy(enc_d),
            torch.from_numpy(prompt), 9, k=3)
    n = int(want.length)
    assert got.length == n and got.target_steps == int(want.target_steps)
    assert got.drafted == int(want.drafted)
    assert got.tokens[:n].tolist() == np.asarray(want.tokens[:n]).tolist()
