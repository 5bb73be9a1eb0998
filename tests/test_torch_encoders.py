"""The port's alternate encoders and front end against the JAX package.

Three tiny models (d32, 4 heads, 2 + 2 layers, vocab 150, CNN (16, 16),
Conformer kernel 7), each built in both packages from one numpy-seeded
JAX tree and carried into the port by ``interop.from_jax``:

* ``post_ln``: a post-LN Transformer (``normalize_before=False``);
* ``conformer_relpos``: a Conformer with ``RelPosMHAXL`` attention;
* ``conformer_causal``: a causal Conformer with regular attention;

and a front end of two layers a block with residuals. Held to the JAX
modules in fp32 at atol 1e-4: ``RelPosMultiHeadAttention`` with a padding
bias, the Conformer layer (non-causal and causal, with a padding mask),
each model's teacher-forced forward and ``encode`` (one jitted JAX
program a model), and the residual front end. The parameter
tree of the relpos Conformer goes through ``load_jax_params`` and
``to_jax_params`` bit for bit. The decoder's step forms, the search and
a train step are in ``test_torch_encoders_decode.py``.
"""

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
from stac_st_tpu.models.conformer import ConformerEncoderLayer
from stac_st_tpu.models.relpos import RelPosMultiHeadAttention
from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.interop.from_jax import load_jax_params, to_jax_params

from test_torch_model import _seeded_leaf

VOCAB, D, NHEAD, LAYERS, FFN, KERNEL = 150, 32, 4, 2, 64, 7
ATOL = 1e-4
MODELS = {
    "post_ln": dict(normalize_before=False),
    "conformer_relpos": dict(encoder_module="conformer",
                             attention_type="RelPosMHAXL",
                             kernel_size=KERNEL),
    "conformer_causal": dict(encoder_module="conformer", causal=True,
                             kernel_size=KERNEL),
}
RESIDUAL_FRONT = dict(num_layers_per_block=2, residuals=(True, True))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def build_jax(settings, front=None, seed=0):
    """JAX modules (dropout 0) with ``settings`` and params from a numpy
    seed (shapes from ``jax.eval_shape``: nothing is compiled)."""
    cnn = ConvolutionFrontEnd(out_channels=(16, 16), dropout=0.0,
                              **(front or {}))
    transformer = TransformerMultiTask(
        tgt_vocab=VOCAB, input_size=20 * 16, d_model=D, nhead=NHEAD,
        num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
        dropout=0.0, **{"normalize_before": True, **settings})
    seq_lin = LinearHead(input_size=D, n_neurons=VOCAB)
    ctc_lin = LinearHead(input_size=D, n_neurons=VOCAB)
    key = jax.random.PRNGKey(0)
    f32 = jnp.float32
    enc = jax.ShapeDtypeStruct((1, 11, D), f32)
    shapes = {
        "CNN": jax.eval_shape(cnn.init, key,
                              jax.ShapeDtypeStruct((1, 41, 80), f32)),
        "Transformer": jax.eval_shape(
            transformer.init, key,
            jax.ShapeDtypeStruct((1, 11, 20, 16), f32),
            jax.ShapeDtypeStruct((1, 4), jnp.int32)),
        "seq_lin": jax.eval_shape(seq_lin.init, key, enc),
        "ctc_lin": jax.eval_shape(ctc_lin.init, key, enc),
    }
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_seeded_leaf(path, s.shape, rng),
                                   np.float32), shapes)
    return dict(cnn=cnn, transformer=transformer, seq_lin=seq_lin,
                ctc_lin=ctc_lin, params=params)


def build_port(jx, settings, front=None, dropout=0.0):
    """The port's modules with the same settings, loaded from the JAX
    tree (fp32, CPU)."""
    mods = dict(
        cnn=P.ConvolutionFrontEnd(out_channels=(16, 16), dropout=dropout,
                                  **(front or {})),
        transformer=P.TransformerMultiTask(
            VOCAB, 20 * 16, d_model=D, nhead=NHEAD,
            num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
            dropout=dropout, **settings),
        seq_lin=P.LinearHead(D, VOCAB), ctc_lin=P.LinearHead(D, VOCAB))
    load_jax_params(jx["params"], **mods, settings=jx["transformer"])
    for m in mods.values():
        m.eval()
    return mods


@pytest.fixture(scope="module")
def models():
    """{name: (jax dict, port modules)} for the three models."""
    out = {}
    for seed, (name, settings) in enumerate(MODELS.items()):
        jx = build_jax(settings, seed=seed)
        out[name] = (jx, build_port(jx, settings))
    return out


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 41, 80)).astype(np.float32)
    tgt = rng.integers(3, VOCAB, (2, 6)).astype(np.int32)
    tgt[1, 4:] = 0  # target padding
    return feats, tgt, np.asarray([1.0, 0.7], np.float32)


def _sub(tree, *keys):
    for k in keys:
        tree = tree[k]
    return tree


def _layer_input(seed):
    """x (2, 9, d) and its padding mask (the second row 6 frames long)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, D)).astype(np.float32)
    pad = np.arange(9)[None, :] >= np.asarray([9, 6])[:, None]
    bias = np.where(pad, -1e9, 0.0).astype(np.float32)[:, None, None, :]
    return x, pad, bias


def test_relpos_attention_matches_jax(models):
    """``RelPosMultiHeadAttention`` of the relpos Conformer's first layer,
    with a key-padding bias."""
    jx, pt = models["conformer_relpos"]
    x, _, bias = _layer_input(2)
    params = {"params": _sub(jx["params"], "Transformer", "params",
                             "encoder", "layer_0", "attn")}
    want, _ = jax.jit(RelPosMultiHeadAttention(D, NHEAD).apply)(
        params, jnp.asarray(x), jnp.asarray(bias))
    attn = pt["transformer"].encoder.layers[0].attn
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", ["conformer_relpos", "conformer_causal"])
def test_conformer_layer_matches_jax(models, name):
    """One ``ConformerEncoderLayer`` (the model's first) with a padding
    bias and the padding mask its convolution zeroes; non-causal with
    relpos attention, causal with regular attention."""
    jx, pt = models[name]
    s = MODELS[name]
    x, pad, bias = _layer_input(3)
    layer = ConformerEncoderLayer(
        D, NHEAD, FFN, KERNEL, 0.0, jax.nn.silu,
        s.get("attention_type", "regularMHA"), s.get("causal", False))
    params = {"params": _sub(jx["params"], "Transformer", "params",
                             "encoder", "layer_0")}
    want = jax.jit(layer.apply)(params, jnp.asarray(x), jnp.asarray(bias),
                                jnp.asarray(pad))
    with torch.no_grad():
        got = pt["transformer"].encoder.layers[0](
            torch.from_numpy(x), torch.from_numpy(bias),
            torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_encode_match_jax(models, name):
    """The teacher-forced forward (training off: the eval mode's kernels'
    plain versions) and ``encode`` (floor-based mask, plain attention),
    both outputs of each."""
    jx, pt = models[name]
    t, cnn = jx["transformer"], jx["cnn"]

    @jax.jit
    def run(params, feats, tgt, wav_len):
        src = cnn.apply(params["CNN"], feats)
        enc, dec = t.apply(params["Transformer"], src, tgt, wav_len)
        return enc, dec, t.apply(params["Transformer"], src, wav_len,
                                 method=t.encode)

    feats, tgt, wav_len = _batch()
    want = run(jx["params"], jnp.asarray(feats), jnp.asarray(tgt),
               jnp.asarray(wav_len))
    with torch.no_grad():
        src = pt["cnn"](torch.from_numpy(feats))
        lens = torch.from_numpy(wav_len)
        enc, dec = pt["transformer"](src, torch.from_numpy(tgt).long(), lens)
        got = (enc, dec, pt["transformer"].encode(src, lens))
    for g, w, what in zip(got, want, ("forward enc", "forward dec",
                                      "encode")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=what)


def test_residual_front_end_matches_jax():
    """Two layers a block (the stride on each block's second), residuals
    on: block 1's first layer keeps its input's shape, so its residual
    adds; the others change shape and add none. The parameter tree has
    ``block{b}_conv{l}`` / ``block{b}_norm{l}`` for l = 0, 1."""
    cnn = ConvolutionFrontEnd(out_channels=(16, 16), dropout=0.0,
                              **RESIDUAL_FRONT)
    shapes = jax.eval_shape(cnn.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 41, 80), jnp.float32))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(_seeded_leaf(path, s.shape, rng),
                                   np.float32), shapes)
    port = P.ConvolutionFrontEnd(out_channels=(16, 16), **RESIDUAL_FRONT)
    load_jax_params({"CNN": params}, cnn=port)
    assert sorted(port.layers) == sorted(params["params"])
    feats, _, _ = _batch()
    want = jax.jit(cnn.apply)(params, jnp.asarray(feats))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(feats))
    assert got.shape == want.shape == (2, 11, 20, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_relpos_conformer_tree_round_trips_bitwise(models):
    """``load_jax_params`` then ``to_jax_params``: the JAX tree of the
    relpos Conformer (pos_proj without bias, u/v biases, the depthwise
    (k, 1, d) kernel) comes back with the same keys and bytes."""
    jx, pt = models["conformer_relpos"]
    got = to_jax_params(**pt)
    want = jx["params"]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
