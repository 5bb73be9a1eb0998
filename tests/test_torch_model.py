"""Port model parity: weights loaded from JAX, encoder, cached decode.

The JAX tiny model (d32, 4 heads, 2+2 layers, vocab 150, CNN (16, 16))
and its PyTorch twin share weights through ``interop.from_jax``; inputs are
made with numpy from a seed. Tolerance: fp32, atol 1e-4 on activations.

``build_jax_tiny`` / ``build_port_twin`` are shared with
``test_torch_engine.py``.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.models import (
    ConvolutionFrontEnd,
    LinearHead,
    TransformerMultiTask,
)
from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.decoding.beam_search import (
    BeamSearchConfig,
    beam_search,
)
from stac_st_tpu_torch.interop.from_jax import load_jax_params

VOCAB, D, NHEAD, LAYERS, FFN = 150, 32, 4, 2, 64
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _seeded_leaf(path, shape, rng):
    """A parameter value from numpy: Glorot-normal kernels/embeddings,
    scales near 1, small nonzero biases (so every import path matters)."""
    name = getattr(path[-1], "key", str(path[-1]))
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "bias":
        return 0.1 * rng.standard_normal(shape)
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    std = np.sqrt(2.0 / (receptive * (shape[-2] + shape[-1])))
    return std * rng.standard_normal(shape)


def build_jax_tiny(seed=0):
    """JAX modules + params made from a numpy seed (shapes from
    ``jax.eval_shape`` of the modules' init: nothing is compiled)."""
    cnn = ConvolutionFrontEnd(out_channels=(16, 16))
    transformer = TransformerMultiTask(
        tgt_vocab=VOCAB, input_size=20 * 16, d_model=D, nhead=NHEAD,
        num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
        dropout=0.0, normalize_before=True,
    )
    seq_lin = LinearHead(input_size=D, n_neurons=VOCAB)
    ctc_lin = LinearHead(input_size=D, n_neurons=VOCAB)
    key = jax.random.PRNGKey(0)
    feats = jax.ShapeDtypeStruct((1, 41, 80), jnp.float32)
    src = jax.ShapeDtypeStruct((1, 11, 20, 16), jnp.float32)
    enc = jax.ShapeDtypeStruct((1, 11, D), jnp.float32)
    shapes = {
        "CNN": jax.eval_shape(cnn.init, key, feats),
        "Transformer": jax.eval_shape(
            transformer.init, key, src,
            jax.ShapeDtypeStruct((1, 4), jnp.int32)),
        "seq_lin": jax.eval_shape(seq_lin.init, key, enc),
        "ctc_lin": jax.eval_shape(ctc_lin.init, key, enc),
    }
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(_seeded_leaf(path, s.shape, rng),
                                    jnp.float32),
        shapes)
    return dict(cnn=cnn, transformer=transformer, seq_lin=seq_lin,
                ctc_lin=ctc_lin, params=params)


def new_port_modules(**settings):
    return dict(
        cnn=P.ConvolutionFrontEnd(out_channels=(16, 16)),
        transformer=P.TransformerMultiTask(
            VOCAB, 20 * 16, d_model=D, nhead=NHEAD,
            num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
            **settings),
        seq_lin=P.LinearHead(D, VOCAB),
        ctc_lin=P.LinearHead(D, VOCAB),
    )


def build_port_twin(jx):
    """The port's modules, loaded from the JAX params (fp32, CPU)."""
    mods = new_port_modules()
    load_jax_params(jax.tree_util.tree_map(np.asarray, jx["params"]), **mods,
                    settings=jx["transformer"])
    return mods


@pytest.fixture(scope="module")
def pair():
    jx = build_jax_tiny()
    return jx, build_port_twin(jx)


def _encoder_batch():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 41, 80)).astype(np.float32)
    return feats, np.asarray([1.0, 0.7], np.float32)


@pytest.fixture(scope="module")
def jax_encode(pair):
    """The JAX encoder, compiled once for the module."""
    jx, _ = pair
    t = jx["transformer"]

    @jax.jit
    def encode(params, feats, wav_len):
        src = jx["cnn"].apply(params["CNN"], feats)
        return t.apply(params["Transformer"], src, wav_len, method=t.encode)

    return encode


@pytest.fixture(scope="module")
def encoded(pair, jax_encode):
    """Encoder outputs of both sides on one seeded batch."""
    jx, pt = pair
    feats, wav_len = _encoder_batch()
    enc_j = jax_encode(jx["params"], jnp.asarray(feats), jnp.asarray(wav_len))
    with torch.no_grad():
        enc_t = pt["transformer"].encode(pt["cnn"](torch.from_numpy(feats)),
                                         torch.from_numpy(wav_len))
    return np.asarray(enc_j), enc_t


def test_from_jax_covers_every_parameter(pair):
    jx, pt = pair
    tree = jax.tree_util.tree_map(np.asarray, jx["params"])
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(tree))
    n_port = sum(p.numel() for m in pt.values() for p in m.parameters())
    assert n_port == n_jax
    # a stray key of the tree raises ...
    stray = {**tree, "ctc_lin": {"params": {
        **tree["ctc_lin"]["params"], "stray": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="not consumed"):
        load_jax_params(stray, **new_port_modules(),
                        settings=jx["transformer"])
    # ... and so does a port parameter the tree does not reach
    mods = new_port_modules()
    mods["seq_lin"].extra = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(KeyError, match="left unset"):
        load_jax_params(tree, **mods, settings=jx["transformer"])


def _tree_for(module, seed=5):
    """Numpy-seeded params of a JAX ``TransformerMultiTask`` whose keys
    differ from the fixture's (shapes from ``jax.eval_shape``)."""
    shapes = jax.eval_shape(
        module.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 11, 20, 16), jnp.float32),
        jax.ShapeDtypeStruct((1, 4), jnp.int32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_seeded_leaf(path, s.shape, rng),
                                   np.float32), shapes)


@pytest.mark.parametrize("field,value", [
    ("normalize_before", False), ("causal", True),
    ("encoder_module", "conformer"), ("attention_type", "RelPosMHAXL"),
    ("positional_encoding", "fixed_rel"), ("nhead", NHEAD // 2)])
def test_from_jax_refuses_settings_the_port_cannot_run(pair, field, value):
    """A tree's keys do not say pre-LN or post-LN, nor the head count: the
    loader reads the JAX module's settings. A JAX model with any setting
    the JAX package runs loads into a port module built with the same
    setting, and the two encoders agree (atol 1e-4); a port module with
    the default settings refuses it where the setting changes what the
    network computes, naming the field (``causal`` acts only in a
    Conformer, ``positional_encoding`` nowhere, in both packages). A
    head count other than the port module's is refused."""
    jx, _ = pair
    jt = jx["transformer"].clone(**{field: value})
    tree = jax.tree_util.tree_map(np.asarray, jx["params"])
    if field == "nhead":
        with pytest.raises(ValueError, match=field):
            load_jax_params(tree, **new_port_modules(), settings=jt)
        return
    if field in ("encoder_module", "attention_type"):
        tree = {**tree, "Transformer": _tree_for(jt)}
    computes_another = field not in ("causal", "positional_encoding")
    if computes_another:
        with pytest.raises(ValueError, match=field):
            load_jax_params(tree, **new_port_modules(), settings=jt)
    mods = new_port_modules(**{field: value})
    load_jax_params(tree, **mods, settings=jt)
    assert getattr(mods["transformer"], field) == value
    feats, wav_len = _encoder_batch()

    @jax.jit
    def encode(params, feats, wav_len):
        src = jx["cnn"].apply(params["CNN"], feats)
        return jt.apply(params["Transformer"], src, wav_len,
                        method=jt.encode)

    want = encode(tree, jnp.asarray(feats), jnp.asarray(wav_len))
    with torch.no_grad():
        got = mods["transformer"].encode(mods["cnn"](torch.from_numpy(feats)),
                                         torch.from_numpy(wav_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_encoder_matches_jax(encoded):
    enc_j, enc_t = encoded
    assert enc_t.shape == enc_j.shape == (2, 11, D)
    np.testing.assert_allclose(enc_t.numpy(), enc_j, atol=ATOL, rtol=0)


def _jax_gather(cache, flat_parent):
    """Gather-mode reorder of the JAX self caches (the searcher's
    cache_gather_fn)."""
    layers = []
    for layer in cache["layers"]:
        sc = layer["self"]
        layers.append({**layer, "self": {
            n: (x if n == "index" else jnp.take(x, flat_parent, axis=0))
            for n, x in sc.items()}})
    return {**cache, "layers": layers}


@pytest.mark.parametrize("beam", [1, 3])
def test_decode_step_matches_jax_gather_mode(pair, encoded, beam):
    """Hidden state at every step: the port (beam 1 layout, or anc mode
    with a non-identity parent sequence) against JAX's decode_step in
    gather mode with the same parents."""
    jx, pt = pair
    enc_j, enc_t = encoded
    t, tp = jx["transformer"], jx["params"]["Transformer"]
    B, steps = enc_j.shape[0], 7
    rng = np.random.default_rng(2)
    tokens = rng.integers(3, VOCAB, (steps, B * beam))
    parents = rng.integers(0, beam, (steps, B, beam))
    cache_j = jax.jit(lambda p, e: t.apply(p, e, steps, None, beam,
                                           method=t.init_decode_cache))(
        tp, jnp.asarray(enc_j))
    step_j = jax.jit(lambda tok, pos, c: t.apply(tp, tok, pos, c,
                                                 method=t.decode_step))
    model = pt["transformer"]
    cache_t = model.init_decode_cache(enc_t, steps, None, beam,
                                      anc_mode=beam > 1)
    with torch.no_grad():
        for p in range(steps):
            if p and beam > 1:
                flat = (np.arange(B)[:, None] * beam + parents[p]).reshape(-1)
                cache_j = _jax_gather(cache_j, jnp.asarray(flat))
                par = torch.from_numpy(parents[p])
                anc = torch.gather(cache_t["anc"], 1,
                                   par[:, :, None].expand(-1, -1, steps))
                anc[:, :, p] = torch.arange(beam, dtype=torch.int32)
                cache_t["anc"] = anc
            h_j, cache_j = step_j(jnp.asarray(tokens[p]),
                                  jnp.asarray(p, jnp.int32), cache_j)
            h_t = model.decode_step(torch.from_numpy(tokens[p]), p, cache_t)
            np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"step {p}")


def test_cached_anc_decode_equals_oracle_decode(pair, encoded):
    """The port's KV-cached anc-mode decode, under a random beam ancestry,
    equals its own full-prefix oracle ``decode`` of each hypothesis's
    reconstructed prefix at every step."""
    _, pt = pair
    _, enc = encoded
    model = pt["transformer"]
    B, beam, steps = enc.shape[0], 4, 6
    rng = np.random.default_rng(3)
    cache = model.init_decode_cache(enc, steps, None, beam, anc_mode=True)
    hist = np.zeros((B, beam, 0), np.int64)
    with torch.no_grad():
        for p in range(steps):
            if p:
                parent = rng.integers(0, beam, (B, beam))
                hist = np.take_along_axis(hist, parent[:, :, None], axis=1)
                par = torch.from_numpy(parent)
                cache["anc"] = torch.gather(
                    cache["anc"], 1, par[:, :, None].expand(-1, -1, steps))
                cache["anc"][:, :, p] = torch.arange(beam, dtype=torch.int32)
            tok = rng.integers(3, VOCAB, (B, beam))
            hist = np.concatenate([hist, tok[:, :, None]], axis=2)
            h = model.decode_step(torch.from_numpy(tok.reshape(-1)), p, cache)
            oracle = model.decode(
                torch.from_numpy(hist.reshape(B * beam, p + 1)),
                enc.repeat_interleave(beam, dim=0))[:, -1]
            np.testing.assert_allclose(h.numpy(), oracle.numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"step {p}")


@pytest.mark.parametrize("beam", [1, 4])
def test_segmented_cache_growth_is_exact(pair, encoded, beam):
    """Decoding in growing cache segments (3, 6, 12, 14 steps here)
    continues the same search: tokens and lengths equal one full-budget
    allocation, in both cache layouts; scores agree to fp32 rounding (the
    plain attention sums over the allocated length, masked positions
    adding exact zeros in another blocking)."""
    _, pt = pair
    _, enc = encoded
    cfg = BeamSearchConfig(beam_size=beam, using_eos_threshold=True,
                           length_normalization=True, temperature=1.15)
    prompt = torch.tensor([1, 3, 4])
    with torch.no_grad():
        grown = beam_search(pt["transformer"], pt["seq_lin"], enc, prompt,
                            14, cfg, cache_growth=3)
        whole = beam_search(pt["transformer"], pt["seq_lin"], enc, prompt,
                            14, cfg, cache_growth=None)
    torch.testing.assert_close(grown[0], whole[0], atol=0, rtol=0)
    torch.testing.assert_close(grown[1], whole[1], atol=0, rtol=0)
    torch.testing.assert_close(grown[2], whole[2], atol=1e-5, rtol=0)


# ------------------------------------------------------------ checkpoints
def _scaled(tree, k):
    """A distinct parameter tree per checkpoint: every leaf times 1 + k/8."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) * np.float32(1 + k / 8), tree)


def _assert_trees_bitwise(got, want):
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def test_port_reads_jax_checkpoints_and_averages_bitwise(pair, tmp_path):
    """Checkpoints the JAX Checkpointer kept (top 2 of 3 by ACC): the port
    finds the same ones in the same order, and its average, loaded into
    the port's modules, equals the JAX average loaded there, bit for bit
    (float64 sums cast back)."""
    from stac_st_tpu.training.checkpoint import Checkpointer as JCkpt
    from stac_st_tpu.training.checkpoint import (
        average_checkpoints as j_average,
    )
    from stac_st_tpu_torch.interop.from_jax import to_jax_params
    from stac_st_tpu_torch.training.checkpoint import (
        Checkpointer,
        average_checkpoints,
    )

    jx, _ = pair
    jck = JCkpt(str(tmp_path))
    for k, acc in enumerate((0.5, 0.7, 0.6)):
        jck.save_and_keep_only(
            meta={"ACC": acc, "epoch": k + 1},
            trees={"model": _scaled(jx["params"], k),
                   "counters": {"optimizer_step": k, "epoch": k + 1}},
            max_keys=["ACC"], num_to_keep=2)
    want = jck.find_checkpoints(max_key="ACC")
    got = Checkpointer(str(tmp_path)).find_checkpoints(max_key="ACC")
    assert [c.path for c in got] == [c.path for c in want]
    assert [c.meta["ACC"] for c in got] == [0.7, 0.6]
    avg = average_checkpoints(got, "model")
    j_avg = jax.tree_util.tree_map(np.asarray, j_average(want, "model"))
    _assert_trees_bitwise(avg, j_avg)
    loaded, j_loaded = new_port_modules(), new_port_modules()
    load_jax_params(avg, **loaded, settings=loaded["transformer"])
    load_jax_params(j_avg, **j_loaded, settings=jx["transformer"])
    _assert_trees_bitwise(to_jax_params(**loaded), to_jax_params(**j_loaded))
    assert got[0].load("counters") == {"epoch": 2, "optimizer_step": 1}


def test_jax_reads_port_checkpoints(pair, encoded, jax_encode, tmp_path):
    """The port's model / normalizer / counters files, written from its
    modules, load through the JAX package's average_checkpoints and
    flax's from_state_dict; the JAX encoder on those weights equals the
    port's encoder (atol 1e-4). The same trees written by each package's
    Checkpointer are byte-equal files."""
    from flax import serialization

    from stac_st_tpu.training.checkpoint import Checkpointer as JCkpt
    from stac_st_tpu.training.checkpoint import (
        average_checkpoints as j_average,
    )
    from stac_st_tpu_torch.interop.from_jax import to_jax_params
    from stac_st_tpu_torch.training.checkpoint import Checkpointer

    jx, pt = pair
    _, enc_t = encoded
    rng = np.random.default_rng(4)
    mean = rng.standard_normal(80).astype(np.float32)
    std = (0.5 + rng.random(80)).astype(np.float32)
    counters = {"optimizer_step": 7, "micro_step": 14, "epoch": 3}
    port_trees = {
        "model": to_jax_params(**pt),
        "normalizer": {"mean": torch.from_numpy(mean),
                       "std": torch.from_numpy(std),
                       "count": torch.tensor(12.0)},
        "counters": counters}
    ours = Checkpointer(str(tmp_path / "port")).save_checkpoint(
        {"ACC": 0.5}, port_trees)
    ckpts = JCkpt(str(tmp_path / "port")).find_checkpoints(max_key="ACC")
    params = serialization.from_state_dict(jx["params"],
                                           j_average(ckpts, "model"))
    feats, wav_len = _encoder_batch()
    enc = jax_encode(params, jnp.asarray(feats), jnp.asarray(wav_len))
    np.testing.assert_allclose(np.asarray(enc), enc_t.numpy(), atol=ATOL,
                               rtol=0)
    norm = ckpts[0].load("normalizer")
    np.testing.assert_array_equal(norm["mean"], mean)
    assert float(norm["count"]) == 12.0
    assert ckpts[0].load("counters") == counters

    jax_trees = {
        "model": jx["params"],
        "normalizer": {"mean": jnp.asarray(mean), "std": jnp.asarray(std),
                       "count": jnp.asarray(12.0, jnp.float32)},
        "counters": counters}
    theirs = JCkpt(str(tmp_path / "jax")).save_checkpoint(
        {"ACC": 0.5}, jax_trees)
    for name in port_trees:
        with open(os.path.join(ours.path, f"{name}.msgpack"), "rb") as f:
            mine = f.read()
        with open(os.path.join(theirs.path, f"{name}.msgpack"), "rb") as f:
            assert f.read() == mine, name
