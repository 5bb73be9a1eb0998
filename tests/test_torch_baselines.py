"""The port's pyannote and Whisper baselines against the JAX package's.

pyannote: one local segmentation checkpoint from the JAX package's
``build_local_segmentation_checkpoint`` (3 Adam steps), built once a
run. The port's build at 3 steps gives its ``state_dict``; each package
loads the other's checkpoint; on the JAX checkpoint the two packages'
posteriors agree within 1e-6, and their ``Binarize`` / ``Peak``
timelines, ``run_pyannote_manifest``'s RTTM files
(segmentation + SCD, and the diarization pipeline) and the drivers' RTTM
files are equal. Both gate ``backend="pyannote"`` where the package is
absent. Whisper: one tiny random checkpoint (the port's
``build_tiny_whisper``), built once a run; both packages' baseline gives
the same texts and BLEU / WER on two utterances. All on the CPU.
"""

import json
import os

# transformers imports TensorFlow, which nothing here uses, when it is
# installed and USE_TF is unset: 8 s more for each worker's first Whisper
# import. Set before this worker's first import of transformers (this
# module is collected before any that imports it).
os.environ.setdefault("USE_TF", "0")

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (this worker's share of the cores)
from torch_once import built_once

from stac_st_tpu.eval import pyannote_baseline as jbase
from stac_st_tpu.eval import pyannote_local as jlocal
from stac_st_tpu_torch.data.audio import write_wav
from stac_st_tpu_torch.eval import pyannote_baseline as pbase
from stac_st_tpu_torch.eval import pyannote_local as plocal
from stac_st_tpu_torch.evaluations.pyannote import run_pyannote_baseline
from stac_st_tpu_torch.evaluations.whisper import run_whisper_baseline

from test_torch_corpora import _jax_driver

SR = 16000
ATOL = 1e-6
STEPS, SEED = 3, 0  # the checkpoint builds' Adam steps and seed


def _shared(tmp_path_factory, name):
    """A folder every xdist worker of this run sees."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        path = tmp_path_factory.getbasetemp().parent / name
        path.mkdir(exist_ok=True)
        return path
    return tmp_path_factory.mktemp(name)


def _conversation(seconds, seed, rate=SR):
    """Two tone speakers (500 Hz, 3 kHz: the checkpoint's training classes)
    in turns, with silences between."""
    rng = np.random.default_rng(seed)
    wav = (0.005 * rng.standard_normal(int(seconds * rate))).astype(
        np.float32)
    t, carrier = 0.4, 500.0
    while t < seconds - 1.0:
        dur = float(rng.uniform(0.8, 2.0))
        i0, i1 = int(t * rate), int(min(t + dur, seconds) * rate)
        tt = np.arange(i1 - i0) / rate
        wav[i0:i1] += (0.5 * np.sin(2 * np.pi * carrier * tt)
                       + 0.1 * rng.standard_normal(i1 - i0))
        carrier = 3000.0 if carrier == 500.0 else 500.0
        t += dur + float(rng.uniform(0.2, 0.6))
    return np.clip(wav, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pyannote_inputs(tmp_path_factory):
    """The JAX package's checkpoint, two conversations (one at 8 kHz,
    resampled on read) and their manifest; made once a run."""
    root = _shared(tmp_path_factory, "torch_baselines_pyannote")

    def build():
        ckpt = str(root / "jax_seg.pt")
        torch.manual_seed(SEED)  # the JAX modules' default init reads it
        jlocal.build_local_segmentation_checkpoint(ckpt, seed=SEED,
                                                   train_steps=STEPS)
        manifest = {}
        for k, (seconds, rate) in enumerate(((6.0, SR), (5.0, 8000))):
            wav = str(root / f"conv{k}.wav")
            write_wav(wav, _conversation(seconds, 10 + k, rate), rate)
            manifest[f"conv{k}-A-000000-{int(seconds * 100):06d}"] = {
                "wav": wav, "duration": seconds}
        with open(root / "manifest.json", "w") as f:
            json.dump(manifest, f)
        return dict(ckpt=ckpt, manifest=str(root / "manifest.json"),
                    wavs=[e["wav"] for e in manifest.values()])

    return built_once(tmp_path_factory, "torch_baselines_pyannote", build)


def test_checkpoint_build_matches_the_jax_build_and_loads_across(
        pyannote_inputs, tmp_path):
    """The port's build from the JAX checkpoint's seed and steps: the
    same state_dict (keys and values); each package loads the other's
    checkpoint."""
    jpath, ppath = pyannote_inputs["ckpt"], str(tmp_path / "port.pt")
    plocal.build_local_segmentation_checkpoint(ppath, seed=SEED,
                                               train_steps=STEPS,
                                               device="cpu")
    j = torch.load(jpath, weights_only=False)
    p = torch.load(ppath, weights_only=False)
    assert list(p["state_dict"]) == list(j["state_dict"])
    assert p["hparams"] == j["hparams"]
    for k, v in j["state_dict"].items():
        torch.testing.assert_close(p["state_dict"][k], v, atol=ATOL, rtol=0)
    assert abs(p["final_loss"] - j["final_loss"]) <= ATOL
    from_jax = plocal.load_local_model(jpath, device="cpu").state_dict()
    from_port = jlocal.load_local_model(ppath).state_dict()
    for k in j["state_dict"]:
        assert torch.equal(from_jax[k], j["state_dict"][k])
        assert torch.equal(from_port[k], p["state_dict"][k])


def test_posteriors_timelines_and_pipeline_match(pyannote_inputs):
    """On the JAX checkpoint: raw chunk posteriors of both conversations
    within 1e-6; for the first, the VAD and SCD tracks within 1e-6,
    Binarize, Peak and the cropped SCD timeline equal, and the
    diarization pipeline's annotation equal (the second's go through the
    RTTM files below)."""
    ckpt = pyannote_inputs["ckpt"]
    jm = jlocal.load_local_model(ckpt)
    pm = plocal.load_local_model(ckpt, device="cpu")
    to_vad = lambda o: np.max(o, axis=2, keepdims=True)  # noqa: E731
    to_scd = lambda p: np.max(  # noqa: E731
        np.abs(np.diff(p, n=1, axis=1)), axis=2, keepdims=True)
    for wav in pyannote_inputs["wavs"]:
        jout, jwin, jstarts, jn = jlocal.LocalInference(jm).chunked(wav)
        pout, pwin, pstarts, pn = plocal.LocalInference(pm).chunked(wav)
        assert (pstarts, pn) == (jstarts, jn)
        np.testing.assert_array_equal(pwin, jwin)
        np.testing.assert_allclose(pout, jout, atol=ATOL, rtol=0)
        if wav != pyannote_inputs["wavs"][0]:
            continue
        tracks = {}
        for name, hook in (("vad", to_vad), ("scd", to_scd)):
            jt = jlocal.LocalInference(jm, pre_aggregation_hook=hook)(wav)
            pt = plocal.LocalInference(pm, pre_aggregation_hook=hook)(wav)
            np.testing.assert_allclose(pt.data, jt.data, atol=ATOL, rtol=0)
            assert vars(pt.sliding_window) == vars(jt.sliding_window)
            tracks[name] = (jt, pt)
        jspeech = jlocal.Binarize(onset=0.5)(tracks["vad"][0])
        pspeech = plocal.Binarize(onset=0.5)(tracks["vad"][1])
        assert [vars(s) for s in pspeech] == [vars(s) for s in jspeech]
        jpeaks = jlocal.Peak(alpha=0.05)(tracks["scd"][0])
        ppeaks = plocal.Peak(alpha=0.05)(tracks["scd"][1])
        assert [vars(s) for s in ppeaks] == [vars(s) for s in jpeaks]
        assert [vars(s) for s in ppeaks.crop(pspeech)] == \
            [vars(s) for s in jpeaks.crop(jspeech)]
        assert len(pspeech) > 0
        jd = jlocal.LocalDiarizationPipeline(jm)(wav, num_speakers=2)
        pd = plocal.LocalDiarizationPipeline(pm)(wav, num_speakers=2)
        assert [(vars(s), t, lab) for s, t, lab in
                pd.itertracks(yield_label=True)] == \
            [(vars(s), t, lab) for s, t, lab in
             jd.itertracks(yield_label=True)]


@pytest.mark.parametrize("pipeline", ["pyannote/segmentation",
                                      "pyannote/speaker-diarization@2.1"])
def test_manifest_rttm_files_are_equal(pyannote_inputs, tmp_path, pipeline):
    """run_pyannote_manifest with the local backend, both packages: the
    RTTM files are byte-equal and hold lines for both conversations."""
    out = {}
    for name, mod, kw in (("jax", jbase, {}),
                          ("port", pbase, {"device": "cpu"})):
        path = str(tmp_path / name / "hyp.rttm")
        lines = mod.run_pyannote_manifest(
            pyannote_inputs["manifest"], path, pipeline=pipeline,
            model_name=pyannote_inputs["ckpt"], backend="local", **kw)
        with open(path, "rb") as f:
            out[name] = (lines, f.read())
    assert out["port"] == out["jax"]
    assert {ln.split()[1].split("-")[0] for ln in out["port"][0]} == \
        {"conv0", "conv1"}


def test_pyannote_backend_gates_in_both(pyannote_inputs, tmp_path):
    for mod in (jbase, pbase):
        with pytest.raises(RuntimeError, match="pyannote.audio is not "
                           "installed"):
            mod.run_pyannote_manifest(pyannote_inputs["manifest"],
                                      str(tmp_path / "x.rttm"))
        with pytest.raises(RuntimeError, match="pyannote.audio is not "
                           "installed"):
            mod.run_pyannote_baseline(pyannote_inputs["wavs"])


def test_pyannote_drivers_write_the_same_rttm(pyannote_inputs, tmp_path):
    """The port's driver (--device cpu) and the JAX driver, both modes, on
    the local checkpoint: the same RTTM file a wav."""
    for mode in ("segmentation", "diarization"):
        argv = ["--wavs", *pyannote_inputs["wavs"], "--mode", mode,
                "--backend", "local", "--model", pyannote_inputs["ckpt"]]
        jout, pout = tmp_path / f"jax_{mode}", tmp_path / f"port_{mode}"
        _jax_driver("evaluations/pyannote/run_pyannote_baseline.py",
                    argv + ["--out", str(jout)])
        run_pyannote_baseline.main(argv + ["--out", str(pout),
                                           "--device", "cpu"])
        names = sorted(os.listdir(jout))
        assert names == sorted(os.listdir(pout)) and len(names) == 2
        for n in names:
            assert (pout / n).read_bytes() == (jout / n).read_bytes(), n


@pytest.fixture(scope="module")
def whisper_inputs(tmp_path_factory):
    """The tiny random Whisper and a two-utterance manifest, made once a
    run."""
    pytest.importorskip("transformers")
    root = _shared(tmp_path_factory, "torch_baselines_whisper")

    def build():
        from stac_st_tpu_torch.eval.whisper_baseline import (
            build_tiny_whisper,
        )

        model = build_tiny_whisper(str(root / "tiny_whisper"), seed=0)
        rng = np.random.default_rng(0)
        data = {}
        for conv in ("20051009_a", "20051010_b"):
            uid = f"{conv}-A-000000-000100"
            wav = str(root / f"{uid}.wav")
            write_wav(wav, (rng.standard_normal(SR) * 0.05).astype(
                np.float32), SR)
            data[uid] = {
                "wav": wav, "duration": 1.0, "source_lang": "es",
                "target_lang": "en", "task": "translation",
                "transcription": "hola qué tal [turn] muy bien",
                **{f"translation_{n}": f"hello how are you ref{n} [xt] fine"
                   for n in range(4)},
            }
        manifest = str(root / "data-st.json")
        with open(manifest, "w") as f:
            json.dump(data, f)
        return dict(model=model, manifest=manifest)

    return built_once(tmp_path_factory, "torch_baselines_whisper", build)


def test_whisper_texts_and_scores_are_equal(whisper_inputs, tmp_path):
    """Both packages' run_whisper_baseline (the port's through its driver,
    --device cpu), both tasks: the same summary and the same hypothesis
    texts and references in the report. One test, so one worker imports
    the Whisper model."""
    from stac_st_tpu.eval.whisper_baseline import run_whisper_baseline as jw

    m, ckpt = whisper_inputs["manifest"], whisper_inputs["model"]
    for task in ("translate", "transcribe"):
        jsum = jw(m, ckpt, task=task, language="es",
                  out_dir=str(tmp_path / "j"))
        psum = run_whisper_baseline.main(
            ["--manifest", m, "--model", ckpt, "--task", task, "--language",
             "es", "--out", str(tmp_path / "p"), "--device", "cpu"])
        assert psum == jsum and ("BLEU" if task == "translate" else "WER") \
            in psum
        name = f"whisper_{task}_data-st.json"
        with open(tmp_path / "j" / name) as f:
            jrep = json.load(f)
        with open(tmp_path / "p" / name) as f:
            prep = json.load(f)
        assert prep == jrep and len(prep["outputs"]) == 2
        assert all("[xt]" not in row[1] for row in prep["outputs"])
