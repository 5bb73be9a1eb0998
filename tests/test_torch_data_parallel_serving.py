"""Data-parallel serving in the port: ``STEngine`` and the slot loop over a
two-shard ``DataMesh`` on the CPU (the device repeats).

A tiny model of numpy-seeded weights (d64, one head of 64, as the card's
decode kernels take; 2 + 2 layers, vocab 150 from the port's BPE on the
fixture corpus; beam 4, buckets of 0.5 and 1 s, eos made competitive and
[turn]/[xt] frequent CTC winners, as in ``tests/test_torch_engine.py``)
serves five inputs: three in the first bucket (an odd row count, padded
to four rows on the mesh) and two in the second. fp32; texts, RTTM
events and tokens must be exactly equal:

* the meshed port engine against the single-device port engine for
  translate, transcribe, the dual search, ``speaker_turns`` and both
  ``long_form`` segmentations;
* the meshed port engine against the JAX engine over a 2-device data
  mesh for translate and ``speaker_turns`` on the first bucket's three
  inputs (one compiled shape each; events held inside each input's valid
  frames, as in ``tests/test_torch_engine.py``);
* the meshed slot loop (4 slots, 2 a shard) against the single-device
  slot loop, on a burst admitted at once.

JAX is imported inside the test that compares with it, so the card test
runs where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_data_parallel_serving.py
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.interop.from_jax import to_jax_params
from stac_st_tpu_torch.ops.cmvn import CmvnState
from stac_st_tpu_torch.parallel.mesh import DataMesh, make_mesh, row_blocks
from stac_st_tpu_torch.serving import STEngine
from stac_st_tpu_torch.serving_continuous import ContinuousBatchingEngine

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import make_corpus  # noqa: E402

VOCAB, D, NHEAD, LAYERS, FFN = 150, 64, 1, 2, 128
BUCKETS, BEAM = (0.5, 1.0), 4
CPU2 = ("cpu", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _modules(ids):
    """The port modules from numpy-seeded leaves: 1.5 x Glorot-normal
    weights (outputs that vary with the input at this width),
    scales near 1, small biases; eos, [turn] and [xt] favoured."""
    mods = dict(
        cnn=P.ConvolutionFrontEnd(out_channels=(16, 16)),
        transformer=P.TransformerMultiTask(
            VOCAB, 20 * 16, d_model=D, nhead=NHEAD,
            num_encoder_layers=LAYERS, num_decoder_layers=LAYERS,
            d_ffn=FFN),
        seq_lin=P.LinearHead(D, VOCAB), ctc_lin=P.LinearHead(D, VOCAB))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for key in sorted(mods):
            for name, p in mods[key].named_parameters():
                if name.endswith("bias"):
                    v = 0.1 * rng.standard_normal(p.shape)
                elif p.dim() == 1:
                    v = 1.0 + 0.1 * rng.standard_normal(p.shape)
                else:
                    fans = p.shape[0] + p.shape[1]
                    recept = int(np.prod(p.shape[2:])) if p.dim() > 2 else 1
                    v = 1.5 * np.sqrt(2.0 / (recept * fans)) * \
                        rng.standard_normal(p.shape)
                p.copy_(torch.from_numpy(v.astype(np.float32)))
        mods["seq_lin"].linear.bias[2] += 0.8
        mods["ctc_lin"].linear.bias[ids["turn"]] += 2.0
        mods["ctc_lin"].linear.bias[ids["xt"]] += 1.9
    return mods


def _cmvn():
    rng = np.random.default_rng(7)
    return CmvnState(
        torch.from_numpy(rng.standard_normal(80).astype(np.float32)),
        torch.from_numpy((1.0 + 0.5 * rng.random(80)).astype(np.float32)),
        torch.tensor(10.0))


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from stac_st_tpu_torch.tokenizer import SentencePieceProcessor
    from stac_st_tpu_torch.tokenizer.train import SentencePiece

    root = str(tmp_path_factory.mktemp("dp_serving"))
    _, _, joint = make_corpus(root, n_utts=4, seconds=0.4)
    tok = SentencePiece(
        model_dir=root, vocab_size=VOCAB, annotation_train=joint,
        annotation_read="transcription_and_translation", model_type="bpe",
        user_defined_symbols="[es],[en],[turn],[xt]", bos_id=1, eos_id=2,
        unk_id=0)
    sp = SentencePieceProcessor(tok.model_path)
    return dict(sp=sp, ids={"turn": sp.piece_to_id("[turn]"),
                            "xt": sp.piece_to_id("[xt]")})


def _engine(shared, mesh=None, device="cpu", **kw):
    m = _modules(shared["ids"])
    return STEngine(m["transformer"], m["cnn"], m["seq_lin"], m["ctc_lin"],
                    _cmvn(), shared["sp"], beam_size=BEAM,
                    bucket_seconds=BUCKETS, bf16=False,
                    turn_id=shared["ids"]["turn"], xt_id=shared["ids"]["xt"],
                    device=device, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def engines(shared):
    return _engine(shared), _engine(shared, make_mesh(2, CPU2))


@pytest.fixture(scope="module")
def wavs():
    rng = np.random.default_rng(7)
    return [(amp * rng.standard_normal(int(s * 16000))).astype(np.float32)
            for s, amp in ((0.3, 0.5), (0.8, 1.0), (0.45, 0.1), (0.9, 0.3),
                           (0.2, 0.6))]


def _conversation(seed=0, bursts=(0.35, 0.5, 0.3, 0.55), pause=0.5):
    """Noise bursts (about -8 dB) between pauses of about -60 dB."""
    rng = np.random.default_rng(seed)
    parts = []
    for dur in bursts:
        parts.append(0.001 * rng.standard_normal(int(pause * 16000)))
        parts.append(0.4 * rng.standard_normal(int(dur * 16000)))
    parts.append(0.001 * rng.standard_normal(int(pause * 16000)))
    return np.concatenate(parts).astype(np.float32)


def _seeded_probs(samples, sample_rate):
    """20 ms energy frames through a sigmoid, plus seeded noise."""
    n = int(sample_rate * 0.02)
    m = len(samples) // n
    db = 10 * np.log10(np.maximum(
        (samples[: m * n].astype(np.float64).reshape(m, n) ** 2).mean(1),
        1e-12))
    noise = np.random.default_rng(9).normal(0, 1.5, m)
    return (1 / (1 + np.exp(-(db + 30 + noise) / 3))).astype(np.float32)


# ---------------------------------------------------------------- tests
def test_mesh_splits_rows_over_repeated_devices():
    mesh = make_mesh(-1, CPU2)
    assert isinstance(mesh, DataMesh) and mesh.shape == {"data": 2}
    assert mesh.distinct == [torch.device("cpu")]
    assert row_blocks(6, 2) == [(0, 3), (3, 6)]
    with pytest.raises(ValueError, match="do not split"):
        row_blocks(5, 2)
    with pytest.raises(ValueError, match="data=3"):
        make_mesh(3, CPU2)


def test_meshed_engine_equals_one_device_on_every_batch_task(engines, wavs):
    one, meshed = engines
    groups = meshed._prepare(wavs)
    assert [tuple(g[1].shape) for g in groups] == [(4, 8000), (2, 16000)]
    assert float(groups[0][2][3]) == 1.0  # the pad row: full-length silence
    assert meshed._replicas.keys() == {torch.device("cpu")}
    out = meshed.translate(wavs)
    assert out == one.translate(wavs)
    assert len({len(t) for t in out}) > 1  # early and full-budget finishes
    assert meshed.transcribe(wavs) == one.transcribe(wavs)
    assert meshed.transcribe_and_translate(wavs) == \
        one.transcribe_and_translate(wavs)
    turns = meshed.speaker_turns(wavs)
    assert turns == one.speaker_turns(wavs)
    assert sum(len(t["turn"]) + len(t["xt"]) for t in turns) > 0


def test_meshed_long_form_equals_one_device_for_both_segmentations(engines):
    one, meshed = engines
    wav = _conversation()
    got = meshed.long_form(wav, uri="conv")
    assert got == one.long_form(wav, uri="conv")
    assert len(got["segments"]) == 4
    kw = dict(segmentation="shas", dac_min_segment_length=0.3,
              dac_max_segment_length=0.9, prob_fn=_seeded_probs)
    shas = meshed.long_form(wav, **kw)
    assert shas == one.long_form(wav, **kw) and shas["segments"]


def test_meshed_engine_equals_the_jax_meshed_engine(shared, engines, wavs):
    import jax.numpy as jnp

    from stac_st_tpu.models import (
        ConvolutionFrontEnd,
        LinearHead,
        TransformerMultiTask,
    )
    from stac_st_tpu.ops.cmvn import CmvnState as JaxCmvn
    from stac_st_tpu.parallel.mesh import make_mesh as jax_mesh
    from stac_st_tpu.serving import STEngine as JaxEngine

    ids = shared["ids"]
    m = _modules(ids)
    jax_engine = JaxEngine(
        TransformerMultiTask(
            tgt_vocab=VOCAB, input_size=20 * 16, d_model=D, nhead=NHEAD,
            num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
            dropout=0.0, normalize_before=True),
        ConvolutionFrontEnd(out_channels=(16, 16)),
        LinearHead(input_size=D, n_neurons=VOCAB),
        LinearHead(input_size=D, n_neurons=VOCAB),
        to_jax_params(m["cnn"], m["transformer"], m["seq_lin"],
                      m["ctc_lin"]),
        JaxCmvn(*(jnp.asarray(t.numpy()) for t in _cmvn())), shared["sp"],
        beam_size=BEAM, bucket_seconds=BUCKETS, bf16=False,
        turn_id=ids["turn"], xt_id=ids["xt"], mesh=jax_mesh(data=2))
    _, meshed = engines
    wavs = [w for w in wavs if len(w) <= 8000]
    assert len(wavs) == 3
    assert meshed.translate(wavs) == jax_engine.translate(wavs)
    ref, got = jax_engine.speaker_turns(wavs), meshed.speaker_turns(wavs)
    for wav, r, g in zip(wavs, ref, got):
        width = meshed._bucket_width(len(wav))
        frames = ((1 + width // 160 + 1) // 2 + 1) // 2  # the two convs
        valid = int(np.ceil(np.float32(len(wav) / width) * frames))
        for name in ("turn", "xt"):
            assert g[name] == [t for t in r[name] if round(t * 25) < valid]


def _slot_texts(engine, wavs, tasks):
    """A burst submitted while the worker is held, so both loops admit the
    same groups; texts in submission order."""
    cont = ContinuousBatchingEngine(engine, slots=4, chunk=4,
                                    max_new_tokens=12)
    try:
        with cont._pause_worker():
            futs = [cont.submit(w, t) for w, t in zip(wavs, tasks)]
        texts = [f.result(timeout=120) for f in futs]
        stats = cont.stats()
    finally:
        cont.close()
    assert stats["completed"] == len(wavs)
    return texts, cont


def test_meshed_slot_loop_is_token_equal_to_one_device(engines, wavs):
    one, meshed = engines
    tasks = ["translate", "transcribe", "translate", "translate",
             "transcribe"]
    want, _ = _slot_texts(one, wavs, tasks)
    got, cont = _slot_texts(meshed, wavs, tasks)
    assert got == want and any(want)
    assert [tuple(st["done"].shape) for st in cont._states] == [(2,), (2,)]


@pytest.mark.parametrize("case", ["slots", "data_parallel"])
def test_serving_refusals_name_what_to_change(case, engines):
    if case == "slots":
        with pytest.raises(ValueError, match="multiple of the mesh"):
            ContinuousBatchingEngine(engines[1], slots=3)
        return
    from stac_st_tpu_torch.recipes import serve

    p = serve.build_parser()
    with pytest.raises(SystemExit, match="--data-parallel 2"):
        serve.data_mesh(p.parse_args(["exp", "--data-parallel", "2"]))
    cpu = serve.data_mesh(p.parse_args(["exp", "--data-parallel", "2",
                                        "--device", "cpu"]))
    assert cpu.devices == (torch.device("cpu"),) * 2
    assert serve.data_mesh(p.parse_args(["exp", "--data-parallel", "-1",
                                         "--device", "cpu"])) is None


@pytest.mark.cuda
def test_two_shards_on_one_card_give_the_one_device_texts(shared, wavs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    one = _engine(shared, device="cuda")
    meshed = _engine(shared, make_mesh(2, ("cuda:0", "cuda:0")))
    assert meshed.translate(wavs) == one.translate(wavs)
    assert meshed.speaker_turns(wavs) == one.speaker_turns(wavs)
