"""The port's SpeechBrain checkpoint bridge (``interop/sb_import.py``,
``interop/sb_export.py``, ``tools/{import,export}_sb_ckpt.py``) against the
JAX package's and against ``tests/sb_oracle.py`` (a torch model with the
reference's SB state-dict names, randomly initialized from a seed).

The imported tree equals the JAX importer's exactly, ``export ∘ import``
gives the oracle's state dict back bitwise, an unmapped parameter raises,
``save_imported`` writes the JAX package's bytes, the port's forward on
the imported weights matches the oracle's within fp32 ``atol 1e-4``, and
``STEngine.from_saved_experiment`` serves the saved checkpoint. The
oracle's small dims: d32, 4 heads, 2 + 2 layers, vocab 50, 16 mels, two
8-channel conv blocks. No JAX program is built.
"""

import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from sb_oracle import OracleDims, build_oracle

from stac_st_tpu.interop import sb_import as jimport
from stac_st_tpu.ops.cmvn import cmvn_init as j_cmvn_init

from stac_st_tpu_torch.interop import sb_export, sb_import
from stac_st_tpu_torch.interop.from_jax import load_jax_params, to_jax_params
from stac_st_tpu_torch.models import (
    ConvolutionFrontEnd,
    LinearHead,
    TransformerMultiTask,
)
from stac_st_tpu_torch.ops.cmvn import CmvnState, cmvn_init
from stac_st_tpu_torch.tools import export_sb_ckpt, import_sb_ckpt

DIMS = OracleDims(d_model=32, nhead=4, n_enc=2, n_dec=2, d_ffn=64, vocab=50,
                  n_mels=16, ch=8)
ATOL = 1e-4

_MODULES_YAML = """\
n_mels: 16
tokenizer_file: {tok}
CNN: !new:stac_st_tpu_torch.models.ConvolutionFrontEnd
    out_channels: (8, 8)
    kernel_sizes: (3, 3)
    strides: (2, 2)
    dropout: 0.0
    input_shape: (8, 10, 16)
Transformer: !new:stac_st_tpu_torch.models.TransformerMultiTask
    tgt_vocab: 50
    input_size: 32
    d_model: 32
    nhead: 4
    num_encoder_layers: 2
    num_decoder_layers: 2
    d_ffn: 64
    dropout: 0.0
seq_lin: !new:stac_st_tpu_torch.models.LinearHead
    input_size: 32
    n_neurons: 50
ctc_lin: !new:stac_st_tpu_torch.models.LinearHead
    input_size: 32
    n_neurons: 50
"""


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def oracle():
    model = build_oracle(DIMS, seed=0)
    return model, model.state_dict()


def _port_modules():
    cnn = ConvolutionFrontEnd(n_mels=DIMS.n_mels, out_channels=(8, 8),
                              dropout=0.0)
    tr = TransformerMultiTask(DIMS.vocab, DIMS.input_size, DIMS.d_model,
                              DIMS.nhead, DIMS.n_enc, DIMS.n_dec, DIMS.d_ffn,
                              dropout=0.0)
    return (cnn, tr, LinearHead(DIMS.d_model, DIMS.vocab),
            LinearHead(DIMS.d_model, DIMS.vocab))


def _load(params):
    cnn, tr, seq_lin, ctc_lin = _port_modules()
    load_jax_params(params, cnn=cnn, transformer=tr, seq_lin=seq_lin,
                    ctc_lin=ctc_lin, settings=tr)
    return cnn, tr, seq_lin, ctc_lin


def _assert_trees_equal(a, b, where=""):
    assert isinstance(b, dict) == isinstance(a, dict), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), where


def test_import_tree_equals_the_jax_importers(oracle):
    _, sd = oracle
    _assert_trees_equal(sb_import.import_model_state_dict(sd),
                        jimport.import_model_state_dict(sd))
    stats = {"glob_mean": torch.arange(16, dtype=torch.float32) / 7,
             "glob_std": torch.linspace(0.5, 2.0, 16),
             "count": torch.tensor(1234.0)}
    port, ref = (sb_import.import_normalizer_dict(stats),
                 jimport.import_normalizer_dict(stats))
    assert isinstance(port, CmvnState)
    for name in ("mean", "std", "count"):
        assert np.array_equal(getattr(port, name).numpy(),
                              np.asarray(getattr(ref, name)))


def test_export_of_import_is_the_state_dict_bitwise(oracle):
    """From the tree and from the port's modules loaded with it; the
    normalizer round-trips too."""
    _, sd = oracle
    ref = {k: v.numpy() for k, v in sd.items()
           if not sb_import._is_buffer(k)}
    params = sb_import.import_model_state_dict(sd)
    for out in (sb_export.export_model_state_dict(params),
                sb_export.export_modules(*_load(params))):
        assert sorted(out) == sorted(ref)
        for k in ref:
            assert np.array_equal(out[k].view(np.uint32),
                                  ref[k].view(np.uint32)), k
    state = CmvnState(torch.arange(16.0) / 3, torch.linspace(1, 2, 16),
                      torch.tensor(7.0))
    back = sb_import.import_normalizer_dict(
        sb_export.export_normalizer_dict(state))
    assert all(torch.equal(a, b) for a, b in zip(back, state))


def test_an_unmapped_parameter_raises_and_pe_buffers_are_ignored(oracle):
    _, sd = oracle
    with_pe = dict(sd, **{"1.pe": torch.zeros(4, 32)})
    sb_import.import_model_state_dict(with_pe)
    bad = dict(sd, **{"1.encoder.layers.0.bogus.weight": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="unmapped"):
        sb_import.import_model_state_dict(bad)


def test_save_imported_writes_the_jax_packages_bytes(oracle, tmp_path):
    _, sd = oracle
    params = sb_import.import_model_state_dict(sd)
    port_dir = sb_import.save_imported(params, str(tmp_path / "port"),
                                       cmvn=cmvn_init(16), source="oracle")
    jax_dir = jimport.save_imported(jimport.import_model_state_dict(sd),
                                    str(tmp_path / "jax"),
                                    cmvn=j_cmvn_init(16), source="oracle")
    for name in ("model.msgpack", "normalizer.msgpack", "meta.json"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_forward_on_imported_weights_matches_the_oracle(oracle):
    """The teacher-forced forward (front end, encoder, decoder, both heads)
    on the valid region, as ``tests/test_weight_import.py`` compares the
    JAX model."""
    model, sd = oracle
    cnn, tr, seq_lin, ctc_lin = _load(sb_import.import_model_state_dict(sd))
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(
        rng.standard_normal((3, 21, DIMS.n_mels)).astype(np.float32))
    tgt = rng.integers(1, DIMS.vocab, size=(3, 7))
    tgt[-1, -2:] = 0
    tgt = torch.from_numpy(tgt)
    wav_len = torch.tensor([1.0, 0.8, 0.55])
    with torch.no_grad():
        src_o = model[0](feats)
        enc_o, dec_o = model[1](src_o, tgt, wav_len)
        seq_o, ctc_o = model[2](dec_o), model[3](enc_o)
        src_p = cnn(feats)
        enc_p, dec_p = tr(src_p, tgt, wav_len)
        seq_p, ctc_p = seq_lin(dec_p), ctc_lin(enc_p)
    assert torch.allclose(src_p.flatten(2), src_o.flatten(2), atol=ATOL)
    valid = torch.round(wav_len * enc_p.shape[1]).long()
    for b in range(3):
        n = int(valid[b])
        assert torch.allclose(enc_p[b, :n], enc_o[b, :n], atol=ATOL)
        assert torch.allclose(ctc_p[b, :n], ctc_o[b, :n], atol=ATOL)
    assert torch.allclose(seq_p[:, :-2], seq_o[:, :-2], atol=ATOL)


def test_tools_round_trip_and_the_engine_serves_the_import(oracle,
                                                           tmp_path):
    """The port's export tool writes ``model.ckpt``/``normalizer.ckpt``
    that its import tool reads back bitwise into ``<exp>/save``, and
    ``STEngine.from_saved_experiment`` loads that experiment."""
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.tokenizer import train_bpe

    _, sd = oracle
    params = sb_import.import_model_state_dict(sd)
    cmvn = CmvnState(torch.arange(16.0) / 5, torch.linspace(1, 3, 16),
                     torch.tensor(9.0))
    ckpt = sb_import.save_imported(params, str(tmp_path / "a"), cmvn=cmvn)
    sb_dir, exp = str(tmp_path / "sb"), tmp_path / "exp"
    assert export_sb_ckpt.main([ckpt, sb_dir]) == 0
    assert import_sb_ckpt.main([sb_dir, str(exp / "save")]) == 0
    loaded = sb_import.load_sb_experiment(sb_dir)
    _assert_trees_equal(loaded["params"], params)
    assert all(torch.equal(a, b) for a, b in zip(loaded["cmvn"], cmvn))

    lines = ["hola que tal amigo mio", "hello how are you my friend"] * 20
    tok = tmp_path / "tok.model"
    train_bpe(lines, vocab_size=DIMS.vocab,
              user_defined_symbols=["[es]", "[en]"]).save(str(tok))
    (exp / "hyperparams.yaml").write_text(_MODULES_YAML.format(tok=tok))
    engine = STEngine.from_saved_experiment(str(exp), device="cpu",
                                            bf16=False)
    served = to_jax_params(engine._cnn, engine._transformer,
                           engine.searcher.seq_lin, engine._ctc_lin)
    _assert_trees_equal(served, params)
    assert all(torch.equal(a, b) for a, b in zip(engine.cmvn, cmvn))
