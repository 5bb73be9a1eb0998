"""The port's data pipeline against the JAX package.

Inputs at fixture size (``tests/fixtures.py::make_corpus``: 16 utterances
of 0.6-0.9 s at 8 kHz, read at 16 kHz, so every file is resampled; some
entries list two files, one is a mu-law SPHERE file) and numpy seeds.
Host code is a copy of the JAX package's and is held to it exactly:
manifests, prompts, audio decoding and resampling, the sampler over epochs
0-2, and every field of every batch of both ``BatchLoader``s over two
epochs, with host and with device speed perturbation. The device resample
is a different convolution (``conv1d`` against XLA's at HIGHEST), held to
the JAX function within 1e-5 abs in fp32 (a sum of at most 31 taps of
O(1) values, each side rounding once a product). Then ``STTrainer.fit``
over the port's loader with ``DeviceSpeedPerturb`` on the CPU.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.data import audio as jaudio
from stac_st_tpu.data import dataset as jdataset
from stac_st_tpu.data import loader as jloader
from stac_st_tpu.data import manifest as jmanifest
from stac_st_tpu.data.resample import _block_bank_c1 as j_bank
from stac_st_tpu.data.resample import fast_resample_poly as j_resample
from stac_st_tpu.data import sampler as jsampler
from stac_st_tpu.data import text as jtext
from stac_st_tpu.ops import speed_perturb as jsp
from stac_st_tpu.parallel.distributed import process_row_block as j_rows
from stac_st_tpu.tokenizer import SentencePieceProcessor as JProcessor

from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.data import audio, dataset, loader, manifest
from stac_st_tpu_torch.data import sampler, text
from stac_st_tpu_torch.data.resample import _block_bank_c1, fast_resample_poly
from stac_st_tpu_torch.ops import speed_perturb as sp
from stac_st_tpu_torch.ops.cmvn import InputNormalization
from stac_st_tpu_torch.ops.fbank import Fbank
from stac_st_tpu_torch.parallel.distributed import process_row_block
from stac_st_tpu_torch.tokenizer import SentencePieceProcessor
from stac_st_tpu_torch.training.optim import AdamW
from stac_st_tpu_torch.training.trainer import STTrainer

from fixtures import make_corpus, train_fixture_tokenizer

SR, FILE_SR, N_UTTS, SPEED_SEED = 16000, 8000, 16, 1234
SAMPLER = dict(max_batch_length=2.5, num_buckets=6, max_batch_ex=3,
               shuffle=True, batch_ordering="random", seed=42)
ATOL_RESAMPLE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _ulaw_sphere(path, payload: bytes, rate=FILE_SR, coding="ulaw"):
    """A one-byte-per-sample NIST SPHERE file (mu-law or A-law coding)."""
    header = ("NIST_1A\n   1024\n"
              f"sample_rate -i {rate}\nchannel_count -i 1\n"
              f"sample_n_bytes -i 1\nsample_coding -s{len(coding)} "
              f"{coding}\nend_head\n").encode()
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + payload)


def _wav(path, fmt: int, bits: int, payload: bytes, rate=FILE_SR,
         channels=1):
    """A RIFF/WAVE file of any format tag (1 PCM, 6 A-law, 7 mu-law)."""
    import struct

    block = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                      rate * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The fixture corpus at 8 kHz, edited into the cases the reference
    schema allows: every fifth entry lists two files (concatenated), one
    entry reads a mu-law SPHERE file; a tokenizer trained by the JAX
    package on the joint text, loaded by each package's processor."""
    root = str(tmp_path_factory.mktemp("data"))
    asr, st, joint = make_corpus(root, n_utts=N_UTTS, seconds=0.6,
                                 sample_rate=FILE_SR, seed=0,
                                 multi_turn_every=3, seconds_jitter=0.4)
    rng = np.random.default_rng(5)
    sph = os.path.join(root, "wav", "ulaw.sph")
    _ulaw_sphere(sph, rng.integers(0, 256, int(0.7 * FILE_SR),
                                   dtype=np.uint8).tobytes())
    for path in (asr, st):
        data = json.load(open(path))
        for i, entry in enumerate(data.values()):
            if i % 5 == 1:
                nxt = f"utt{(i + 1) % N_UTTS:03d}.wav"
                entry["wav"] += " {data_root}/wav/" + nxt
                entry["duration"] += 0.6 + 0.1 * ((i + 1) % 4)
            if i == 4:
                entry["wav"] = "{data_root}/wav/ulaw.sph"
                entry["duration"] = 0.7
        json.dump(data, open(path, "w"))
    _, model = train_fixture_tokenizer(root, joint)
    return dict(root=root, asr=asr, st=st, rep={"data_root": root},
                tok_j=JProcessor(model), tok_p=SentencePieceProcessor(model))


# ---------------------------------------------------------- host copies
def test_manifest_text_and_rows_match_jax(corpus):
    for path in (corpus["asr"], corpus["st"]):
        got = manifest.load_manifest(path, corpus["rep"])
        assert got == jmanifest.load_manifest(path, corpus["rep"])
        for entry in got.values():
            assert manifest.wav_paths(entry) == jmanifest.wav_paths(entry)
            for inc in (False, True):
                assert text.build_target_ids(
                    entry, corpus["tok_p"], include_xt=inc,
                    include_turn=inc) == jtext.build_target_ids(
                    entry, corpus["tok_j"], include_xt=inc,
                    include_turn=inc)
            t = entry["translation_0"]
            assert text.strip_special_tokens(t) == \
                jtext.strip_special_tokens(t)
    for lang in ("es", "[en]", "turn"):
        assert text.lang_token_id(corpus["tok_p"], lang) == \
            jtext.lang_token_id(corpus["tok_j"], lang)
    assert manifest.split_name("a/dev-30s/data-st") == \
        jmanifest.split_name("a/dev-30s/data-st")
    for v in ("0.5 1.25 ", 3, [1, 2.5], None):
        assert manifest.parse_segments_field(v) == \
            jmanifest.parse_segments_field(v)
    for args in ((10, 4, 1, 2), (7, 8, 3, 4), (1, 2, 0, 2)):
        assert process_row_block(*args) == j_rows(*args)
    with pytest.raises(ValueError):
        process_row_block(8, 3, 0, 2)


@pytest.mark.parametrize("kind", ["pcm16_wav", "pcm8_wav", "ulaw_wav",
                                  "alaw_wav", "ulaw_sphere", "alaw_sphere",
                                  "stereo_wav"])
def test_read_audio_matches_jax(corpus, kind, tmp_path):
    """Each container and coding, read as stored and at 16 kHz (8 kHz ->
    16 kHz through the polyphase resampler), bit-equal. (Both readers
    decode an A-law SPHERE file's bytes as mu-law, the JAX reader's
    one-byte fallback.)"""
    rng = np.random.default_rng(len(kind))
    n = 4001
    path = str(tmp_path / kind)
    if kind == "pcm16_wav":
        audio.write_wav(path, 0.3 * rng.standard_normal(n), FILE_SR)
        with open(path, "rb") as f:  # the port's writer is the JAX one's
            data = f.read()
        jaudio.write_wav(path + ".j", 0.3 * np.random.default_rng(
            len(kind)).standard_normal(n), FILE_SR)
        assert open(path + ".j", "rb").read() == data
    elif kind == "pcm8_wav":
        _wav(path, 1, 8, rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    elif kind in ("ulaw_wav", "alaw_wav"):
        _wav(path, 7 if kind == "ulaw_wav" else 6, 8,
             rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    elif kind in ("ulaw_sphere", "alaw_sphere"):
        _ulaw_sphere(path, rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
                     coding=kind[:4])
    else:
        _wav(path, 1, 16, rng.integers(-30000, 30000, 2 * n)
             .astype("<i2").tobytes(), channels=2)
    for rate in (None, SR):
        got, got_sr = audio.read_audio(path, sample_rate=rate)
        want, want_sr = jaudio.read_audio(path, sample_rate=rate)
        assert got_sr == want_sr == (rate or FILE_SR)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with open(str(tmp_path / "x.flac"), "wb") as f:
        f.write(b"fLaC" + bytes(64))
    with pytest.raises(ValueError):
        audio.read_audio(str(tmp_path / "x.flac"))


def test_resampler_matches_jax():
    rng = np.random.default_rng(3)
    for up, down in ((2, 1), (10, 9), (10, 11), (1, 3), (160, 147)):
        for a, b in zip(_block_bank_c1(up, down), j_bank(up, down)):
            np.testing.assert_array_equal(a, b)
        for n in (1, 97, 4000):
            x = rng.standard_normal(n).astype(np.float32)
            np.testing.assert_array_equal(fast_resample_poly(x, up, down),
                                          j_resample(x, up, down))


@pytest.mark.parametrize("boundaries", ["sb_warped", "quantile"])
def test_sampler_matches_jax_over_epochs(corpus, boundaries):
    ds = dataset.SpeechDataset(corpus["asr"], None, replacements=corpus["rep"])
    lengths = ds.durations()
    for ordering in ("random", "descending"):
        kw = dict(SAMPLER, batch_ordering=ordering, boundaries=boundaries)
        got = sampler.DynamicBatchSampler(lengths, **kw)
        want = jsampler.DynamicBatchSampler(lengths, **kw)
        assert got.bucket_shapes() == want.bucket_shapes()
        assert len(got) == len(want)
        for epoch in range(3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert list(got) == list(want)
    assert dataset.sort_ids(ds, "descending") == \
        jdataset.sort_ids(ds, "descending")
    assert dataset.sort_ids(ds, "ascending") == \
        jdataset.sort_ids(ds, "ascending")


def _loaders(corpus, perturb: str, workers: int, shard: bool):
    """The same loader built from each package's classes."""
    out = []
    for pkg_ds, pkg_sp, pkg_sampler, pkg_loader, tok in (
            (dataset, sp, sampler, loader, corpus["tok_p"]),
            (jdataset, jsp, jsampler, jloader, corpus["tok_j"])):
        speed = None
        if perturb != "none":
            cls = (pkg_sp.DeviceSpeedPerturb if perturb == "device"
                   else pkg_sp.SpeedPerturb)
            speed = cls(orig_freq=SR, speeds=[90, 100, 110])
            speed.seed(SPEED_SEED)
        ds = pkg_ds.SpeechDataset(corpus["st"], tok, sample_rate=SR,
                                  replacements=corpus["rep"],
                                  speed_perturb=speed)
        smp = pkg_sampler.DynamicBatchSampler(ds.durations(), **SAMPLER)
        ld = pkg_loader.BatchLoader(ds, smp, sample_rate=SR,
                                    token_pad_multiple=8,
                                    num_workers=workers)
        if shard:
            ld.set_shard(1, 2, 2)
        out.append(ld)
    return out


def _assert_batches_equal(got, want):
    assert got.id == want.id
    for name in ("sig", "tokens", "tokens_bos", "tokens_eos"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for name in ("duration", "task", "source_lang", "target_lang", "extras"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("perturb,workers,shard", [
    ("host", 1, False), ("host", 3, False), ("device", 1, False),
    ("device", 3, False), ("device", 3, True)])
def test_loader_batches_match_jax_over_two_epochs(corpus, perturb, workers,
                                                  shard):
    """Every field of every batch; speeds keyed by (epoch, row) redraw in
    the second epoch; the shard case decodes only rows of block 1 of 2."""
    got_ld, want_ld = _loaders(corpus, perturb, workers, shard)
    draws = []
    for epoch in (1, 2):
        got_ld.set_epoch(epoch)
        want_ld.set_epoch(epoch)
        assert got_ld.dataset.epoch == epoch
        got, want = list(got_ld), list(want_ld)
        assert len(got) == len(want) == len(got_ld)
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
        for b in got:
            spec = got_ld.sampler.bucket_of(got_ld.dataset.ids.index(b.id[0]))
            bucket = int(np.ceil(spec.boundary * SR))
            if perturb == "device":  # the bucket's width; the step widens
                assert b.sig.data.shape[1] == bucket
                assert len(b.speed_idx) == len(b)
            else:  # a 90%-speed row may widen its batch to the 0.5 s grid
                width = b.sig.data.shape[1]
                assert width == bucket or (width > bucket
                                           and width % 8000 == 0)
        if perturb == "device":
            draws.append(sorted((i, s) for b in got
                                for i, s in zip(b.id, b.speed_idx)))
    if perturb == "device":
        assert draws[0] != draws[1]


def test_loader_without_sampler_matches_jax(corpus):
    kw = dict(batch_size=3, shuffle=True, seed=3, drop_last=True,
              sample_rate=SR)
    got = loader.BatchLoader(dataset.SpeechDataset(
        corpus["asr"], corpus["tok_p"], replacements=corpus["rep"]), **kw)
    want = jloader.BatchLoader(jdataset.SpeechDataset(
        corpus["asr"], corpus["tok_j"], replacements=corpus["rep"]), **kw)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for g, w in zip(list(got), list(want), strict=True):
            _assert_batches_equal(g, w)


# ------------------------------------------------- device speed perturb
@pytest.mark.parametrize("width", [4001, 12347])
@pytest.mark.parametrize("speed", [90, 100, 110])
def test_device_resample_matches_jax(speed, width):
    x = np.random.default_rng(width + speed).standard_normal(
        (2, width)).astype(np.float32)
    perturb = sp.DeviceSpeedPerturb(speeds=[90, 100, 110])
    w_out = perturb.out_width(width)
    assert w_out == jsp.DeviceSpeedPerturb(speeds=[90, 100, 110]).out_width(
        width)
    got = sp.device_resample(torch.from_numpy(x), 100, speed, w_out)
    want = np.asarray(jsp.device_resample(jnp.asarray(x), 100, speed, w_out))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_RESAMPLE, rtol=0)
    # and over the host resample's length it is the host resample
    host = sp.SpeedPerturb(speeds=[speed])(x[0], speed)
    np.testing.assert_allclose(got[0, :len(host)].numpy(), host,
                               atol=ATOL_RESAMPLE, rtol=0)


def test_device_speed_perturb_apply_matches_jax():
    rng = np.random.default_rng(4)
    sig = rng.standard_normal((4, 9001)).astype(np.float32)
    rel = np.asarray([1.0, 0.5, 0.77, 0.31], np.float32)
    idx = np.asarray([0, 1, 2, 0], np.int32)
    perturb = sp.DeviceSpeedPerturb(speeds=[90, 100, 110])
    got, got_rel = perturb.apply(torch.from_numpy(sig), torch.from_numpy(rel),
                                 torch.from_numpy(idx))
    want, want_rel = jsp.DeviceSpeedPerturb(speeds=[90, 100, 110]).apply(
        jnp.asarray(sig), jnp.asarray(rel), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_RESAMPLE, rtol=0)
    np.testing.assert_array_equal(got_rel.numpy(), np.asarray(want_rel))
    half = torch.from_numpy(sig).to(torch.bfloat16)
    out, _ = perturb.apply(half, torch.from_numpy(rel), torch.from_numpy(idx))
    assert out.dtype == torch.bfloat16  # computed in fp32, cast back
    # one explicit seed: each package's default is its own process-global
    # seed, which an earlier test in the worker (a recipe) may have set
    jax_perturb = jsp.DeviceSpeedPerturb(speeds=[90, 100, 110])
    for p in (perturb, jax_perturb):
        p.seed(SPEED_SEED)
    for key in ((0, 3), (1, 3), (7, 11)):
        assert perturb.index_for(key) == jax_perturb.index_for(key)


# ------------------------------------------------------------- trainer
def test_fit_over_loader_with_device_speed_perturb(corpus):
    """Two steps of STTrainer.fit on the CPU over the port's loader: the
    step's fbank sees the device-perturbed signal (each row its speed's
    resample, at the slowest speed's width), and the losses are finite."""
    speed = sp.DeviceSpeedPerturb(orig_freq=SR, speeds=[90, 100, 110])
    speed.seed(SPEED_SEED)
    ds = dataset.SpeechDataset(corpus["st"], corpus["tok_p"], sample_rate=SR,
                               replacements=corpus["rep"],
                               speed_perturb=speed)
    ld = loader.BatchLoader(
        ds, sampler.DynamicBatchSampler(ds.durations(), **SAMPLER),
        sample_rate=SR, token_pad_multiple=8, num_workers=2)
    vocab, d = 150, 32
    mods = dict(cnn=P.ConvolutionFrontEnd(n_mels=16, out_channels=(8, 8)),
                transformer=P.TransformerMultiTask(
                    vocab, 4 * 8, d_model=d, nhead=4, num_encoder_layers=1,
                    num_decoder_layers=1, d_ffn=64),
                seq_lin=P.LinearHead(d, vocab), ctc_lin=P.LinearHead(d, vocab))
    gen = torch.Generator().manual_seed(0)
    for m in mods.values():
        P.glorot_init_(m, gen)
    fbank, seen = Fbank(n_mels=16), []

    def features(wavs):
        seen.append(wavs.detach().clone())
        return fbank(wavs)

    trainer = STTrainer(
        {"CNN": mods["cnn"], "Transformer": mods["transformer"],
         "seq_lin": mods["seq_lin"], "ctc_lin": mods["ctc_lin"],
         "normalize": InputNormalization(update_until_epoch=4)},
        AdamW(lr=1e-3),
        dict(compute_features=features, ctc_weight=0.3, label_smoothing=0.1,
             n_mels=16, seed=3, speed_perturb=speed),
        {"debug": True, "debug_batches": 2}, device="cpu")
    assert trainer.cfg.device_speed is speed
    trainer.fit([1], ld)
    losses = [float(x) for x in trainer.epoch_losses]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    ld.set_epoch(1)
    first = next(iter(ld))
    sig = torch.from_numpy(first.sig.data)
    want, _ = speed.apply(sig, torch.from_numpy(first.sig.lengths),
                          torch.tensor(first.speed_idx))
    torch.testing.assert_close(seen[0], want, atol=0, rtol=0)
    assert seen[0].shape[1] == speed.out_width(sig.shape[1]) > sig.shape[1]
    for row, s in enumerate(first.speed_idx):
        unperturbed = torch.equal(seen[0][row, :sig.shape[1]], sig[row])
        assert unperturbed == (speed.speeds[s] == 100)
