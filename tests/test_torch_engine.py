"""The port's engine against the JAX ``STEngine`` on the tiny fixture.

Both engines serve the same weights (loaded into the port through
``interop.from_jax``) in fp32 on the CPU; the JAX engine runs its default
XLA path (Pallas off, gather-mode beam). Texts must be identical, on
identical batches, for every call, on inputs that fall into two buckets;
the port's fused ``transcribe_and_translate`` is held to the JAX engine's
two single-prompt calls, which its fused call equals exactly.
This file runs at beam ``BEAM`` = 4; ``test_torch_engine_beam1.py`` runs
the same tests at beam 1, in a file of its own so that the two JAX
reference engines (each built once per module) compile on different
test workers. ``long_form`` (a conversation of noise bursts between quiet
pauses) is held to the JAX dict, segments, texts and RTTM, for both
segmentations (``shas`` with a seeded frame classifier).
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.ops.cmvn import CmvnState as JaxCmvnState
from stac_st_tpu.serving import STEngine as JaxEngine
from stac_st_tpu_torch.interop.from_jax import cmvn_from_jax
from stac_st_tpu_torch.serving import STEngine as PortEngine

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import build_jax_tiny, build_port_twin  # noqa: E402

BUCKETS = (0.5, 1.0)
BEAM = 4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    import jax.numpy as jnp

    from fixtures import make_corpus, train_fixture_tokenizer

    root = str(tmp_path_factory.mktemp("torch_engine"))
    _, _, joint = make_corpus(root, n_utts=4, seconds=0.4)
    sp, _ = train_fixture_tokenizer(root, joint, vocab=150)
    jx = build_jax_tiny(seed=1)
    # make [turn]/[xt] frequent CTC winners so speaker_turns has events,
    # some of them in padded frames
    ids = {"turn": sp.piece_to_id("[turn]"), "xt": sp.piece_to_id("[xt]")}
    bias = np.asarray(jx["params"]["ctc_lin"]["params"]["linear"]["bias"])
    bias = bias.copy()
    bias[ids["turn"]] += 2.0
    bias[ids["xt"]] += 1.9
    jx["params"]["ctc_lin"]["params"]["linear"]["bias"] = jnp.asarray(bias)
    # and make eos competitive, so some hypotheses finish early (the
    # finished-set merge and the early exit run) while others run the
    # whole budget (the alive fallback)
    seq = jx["params"]["seq_lin"]["params"]["linear"]
    seq["bias"] = seq["bias"].at[2].add(0.8)
    rng = np.random.default_rng(7)
    cmvn = JaxCmvnState(
        mean=jnp.asarray(rng.standard_normal(80), jnp.float32),
        std=jnp.asarray(1.0 + 0.5 * rng.random(80), jnp.float32),
        count=jnp.asarray(10.0, jnp.float32))
    wavs = [
        (amp * rng.standard_normal(int(s * 16000))).astype(np.float32)
        for s, amp in ((0.3, 0.5), (0.8, 1.0), (0.45, 0.1), (0.9, 0.3))
    ]
    return dict(sp=sp, jx=jx, cmvn=cmvn, ids=ids, wavs=wavs)


@pytest.fixture(scope="module")
def engines(request, shared):
    beam = request.module.BEAM
    jx, sp, ids = shared["jx"], shared["sp"], shared["ids"]
    opts = dict(beam_size=beam, bucket_seconds=BUCKETS, bf16=False,
                turn_id=ids["turn"], xt_id=ids["xt"])
    jax_engine = JaxEngine(jx["transformer"], jx["cnn"], jx["seq_lin"],
                           jx["ctc_lin"], jx["params"], shared["cmvn"], sp,
                           **opts)
    pt = build_port_twin(jx)
    port_engine = PortEngine(pt["transformer"], pt["cnn"], pt["seq_lin"],
                             pt["ctc_lin"], cmvn_from_jax(shared["cmvn"]), sp,
                             device="cpu", **opts)
    return jax_engine, port_engine


def test_inputs_fall_in_two_buckets(engines, shared):
    _, port = engines
    groups = port._prepare(shared["wavs"])
    assert [g[1].shape[1] for g in groups] == [8000, 16000]


def test_translate_matches_jax(engines, shared):
    jax_engine, port = engines
    out = port.translate(shared["wavs"])
    assert out == jax_engine.translate(shared["wavs"])
    assert len({len(t) for t in out}) > 1  # early and full-budget finishes


def test_transcribe_matches_jax(engines, shared):
    jax_engine, port = engines
    assert port.transcribe(shared["wavs"]) == \
        jax_engine.transcribe(shared["wavs"])


def test_transcribe_and_translate_matches_jax(engines, shared):
    """The port's fused dual-prompt search against the JAX engine's two
    single-prompt searches, which its own fused call equals exactly (each
    tile's rows never interact; the JAX package holds that in
    ``tests/test_serving.py::TestSTEngine::
    test_transcribe_and_translate_matches_separate_calls``): the programs
    the translate and transcribe tests compile serve here too."""
    jax_engine, port = engines
    wavs = shared["wavs"]
    assert port.transcribe_and_translate(wavs) == (
        jax_engine.transcribe(wavs), jax_engine.translate(wavs))


def test_speaker_turns_matches_jax(engines, shared):
    """The port forces frames past each input's length to blank; the JAX
    ``speaker_turns`` does not, so it is held to the JAX events that fall
    inside each input's valid frames (ceil(len/width · frames))."""
    jax_engine, port = engines
    wavs = shared["wavs"]
    ref = jax_engine.speaker_turns(wavs)
    got = port.speaker_turns(wavs)
    n_padded = 0
    for wav, r, g in zip(wavs, ref, got):
        width = port._bucket_width(len(wav))
        frames = (1 + width // 160 + 1) // 2  # fbank frames, conv 1
        frames = (frames + 1) // 2            # conv 2
        valid = int(np.ceil(np.float32(len(wav) / width) * frames))
        for name in ("turn", "xt"):
            inside = [t for t in r[name] if round(t * 25) < valid]
            n_padded += len(r[name]) - len(inside)
            assert g[name] == inside
    assert sum(len(g["turn"]) + len(g["xt"]) for g in got) > 0
    assert n_padded > 0  # the padded-frame rule was exercised


def _port_engine(shared, **kw):
    pt = build_port_twin(shared["jx"])
    opts = dict(beam_size=BEAM, bucket_seconds=BUCKETS, bf16=False,
                device="cpu")
    opts.update(kw)
    return PortEngine(pt["transformer"], pt["cnn"], pt["seq_lin"],
                      pt["ctc_lin"], cmvn_from_jax(shared["cmvn"]),
                      shared["sp"], **opts)


def test_pad_batch_rows_ladder(shared):
    """A ladder pads each bucket's rows to the smallest rung that fits
    (past the top rung, to a multiple of it); padded rows are dropped and
    change nothing against the same row count from int padding."""
    wavs = [w[:3000] for w in shared["wavs"][:3]]  # one bucket, 3 inputs
    ladder = _port_engine(shared, pad_batch_rows=(2, 8))
    (_, batch, lens), = ladder._prepare(wavs)
    assert batch.shape[0] == 8 and float(lens[3:].min()) == 1.0
    assert ladder._prepare(wavs[:1])[0][1].shape[0] == 2
    assert _port_engine(shared, pad_batch_rows=(1, 2))._prepare(
        wavs)[0][1].shape[0] == 4
    assert ladder.translate(wavs) == \
        _port_engine(shared, pad_batch_rows=8).translate(wavs)


def test_pcm16_transfer_matches_float(shared):
    """transfer_dtype='int16' moves PCM16 to the device and unpacks it
    there; 16-bit-exact audio decodes exactly as the float transfer."""
    rng = np.random.default_rng(5)
    ints = rng.integers(-2000, 2000, int(0.4 * 16000)).astype(np.int16)
    wav = ints.astype(np.float32) / 32768.0
    eng_i = _port_engine(shared, transfer_dtype="int16")
    assert eng_i._prepare([wav])[0][1].dtype == torch.int16
    assert eng_i.translate([wav, ints]) == \
        _port_engine(shared).translate([wav, wav])


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


def test_long_form_matches_jax(engines):
    """The whole-conversation call, both segmentations, equal to the JAX
    engine's dict: segment times, raw texts, merged texts and the
    absolute-time RTTM lines, with events in it."""
    jax_engine, port = engines
    wav = _conversation()
    pause = port.long_form(wav, uri="conv")
    assert pause == jax_engine.long_form(wav, uri="conv")
    assert len(pause["segments"]) == 4
    assert pause["rttm"]["turn"] or pause["rttm"]["xt"]
    kw = dict(segmentation="shas", dac_min_segment_length=0.3,
              dac_max_segment_length=0.9, prob_fn=_seeded_probs)
    shas = port.long_form(wav, **kw)
    assert shas == jax_engine.long_form(wav, **kw)
    assert shas["segments"] and shas["segments"] != pause["segments"]
