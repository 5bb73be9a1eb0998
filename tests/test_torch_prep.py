"""The port's Fisher/CALLHOME preparation and resegmentation chain against
the JAX package's, on one seeded raw tree in the LDC layouts
(``stac_st_tpu_torch/examples/ldc_tree.py``: two Fisher and two CALLHOME
conversations of 30 s, two-channel 8 kHz µ-law SPHERE, overlapping turns
so that ``[turn] [xt]`` occurs).

Both packages write into the same folder in turn, so every manifest, YAML
file and wav is compared byte for byte (paths inside included): the
single-turn manifests, the multi-turn ones at 30/60/90 s, the masked
conversations, the pause-based and SHAS segmentation YAML files and the
resegmented manifests with their cuts. The port's Moses stages are held to
sacremoses on seeded English and Spanish text. No JAX program is built.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
from filelock import FileLock

from stac_st_tpu.prep import callhome as jcallhome
from stac_st_tpu.prep import fisher as jfisher
from stac_st_tpu.prep import shas as jshas

from stac_st_tpu_torch.data.audio import read_audio, write_wav
from stac_st_tpu_torch.datasets.fisher_callhome import (
    run_data_preparation_turns,
)
from stac_st_tpu_torch.examples.ldc_tree import make_ldc_tree
from stac_st_tpu_torch.prep import callhome, fisher, shas
from stac_st_tpu_torch.utils import moses

TURNS = (30, 60, 90)


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _run_in_turn(out, run):
    """``run(package, out)`` for the JAX package then the port, into the
    same folder; the files each wrote, by relative path."""
    written = {}
    for name in ("jax", "port"):
        shutil.rmtree(out, ignore_errors=True)
        run(name, out)
        written[name] = _tree_bytes(out)
    return written


def _prepare(raw, corpus):
    def run(name, out):
        f, c = (jfisher, jcallhome) if name == "jax" else (fisher, callhome)
        f.prepare_fisher(raw, out, corpus_path=corpus,
                         datasets=["train", "dev"])
        c.prepare_callhome(raw, out, corpus_path=corpus,
                           datasets=["train", "devtest"])
        for seconds in TURNS:
            f.prepare_fisher_turns(raw, out, seconds, corpus_path=corpus,
                                   datasets=["train", "dev"])
            c.prepare_callhome_turns(raw, out, seconds, corpus_path=corpus,
                                     datasets=["train", "devtest"])
    return run


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """The tree and both packages' preparation of it, made once a run:
    under xdist the first worker writes it to a folder the workers share
    and the others read it."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = tmp_path_factory.getbasetemp().parent / "torch_prep"
    else:
        root = tmp_path_factory.mktemp("torch_prep")
    done = root / "written.pkl"
    with FileLock(str(root) + ".lock"):
        if not done.is_file():
            root.mkdir(exist_ok=True)
            tree = make_ldc_tree(str(root / "ldc"), seconds=30.0, seed=3)
            written = _run_in_turn(str(root / "out"),
                                   _prepare(tree["raw"], tree["corpus"]))
            done.write_bytes(pickle.dumps(dict(tree=tree, written=written)))
        data = pickle.loads(done.read_bytes())
    return dict(data, out=str(root / "out"), root=root)


def test_manifests_and_wavs_are_byte_equal(prepared):
    jax_files, port_files = prepared["written"]["jax"], \
        prepared["written"]["port"]
    assert sorted(port_files) == sorted(jax_files)
    manifests = [p for p in jax_files if p.endswith(".json")]
    # single-turn: fisher train/dev, callhome train/devtest; turns: each
    # of those at 30/60/90 s; an asr and an st file each
    assert len(manifests) == 4 * 2 * (1 + len(TURNS))
    assert sum(p.endswith(".wav") for p in jax_files) > 20
    for path, data in jax_files.items():
        assert port_files[path] == data, path


def test_turn_markers_and_segment_metadata(prepared):
    texts, n_entries = [], 0
    for seconds in TURNS:
        for split in ("train", "callhome-train", "dev", "callhome-devtest"):
            path = os.path.join(prepared["out"], f"{split}-{seconds}s",
                                "data-turns-st.json")
            with open(path) as f:
                data = json.load(f)
            for entry in data.values():
                n_entries += 1
                turns = entry["transcription"].count("[turn]")
                assert entry["nb_turns"] == turns
                assert len(entry["segments_start"].split(" ")) == turns + 1
                assert entry["duration"] < 1.2 * seconds
                texts.append(entry["transcription"])
    joined = " ".join(texts)
    assert n_entries > 0
    assert joined.count("[turn]") > 0 and joined.count("[turn] [xt]") > 0


def _segment(base, method):
    def run(name, out):
        mod = jshas if name == "jax" else shas
        masked = os.path.join(out, "masked")
        mod.mask_wav_files(os.path.join(base, "data.json"),
                           os.path.join(base, "wavs"), masked)
        segments = []
        for rec in sorted(os.listdir(masked)):
            wav = os.path.join(masked, rec)
            segments += (mod.pause_based_segmentation(wav) if method == "pause"
                         else mod.shas_segmentation(wav, 2.0, 6.0))
        yaml_path = os.path.join(out, f"{method}.yaml")
        mod.write_segmentation_yaml(segments, yaml_path)
        mod.create_json_and_segment(yaml_path, base, masked,
                                    os.path.join(out, "resegmented"))
        for task in ("asr", "st"):  # written beside data.json
            os.replace(os.path.join(base, f"data-resegmented-{task}.json"),
                       os.path.join(out, f"data-resegmented-{task}.json"))
    return run


@pytest.mark.parametrize("method", ["pause", "shas"])
def test_resegmentation_chain_is_byte_equal(prepared, method):
    """mask_wav_files, the segmentation YAML and create_json_and_segment
    over the dev conversations (16 kHz mono, the ground truth the dev
    manifest's keys)."""
    base = str(prepared["root"] / f"base_{method}")
    os.makedirs(os.path.join(base, "wavs"), exist_ok=True)
    with open(os.path.join(prepared["out"], "dev", "data-st.json")) as f:
        gt = json.load(f)
    with open(os.path.join(base, "data.json"), "w") as f:
        json.dump(gt, f)
    speech = os.path.join(prepared["tree"]["raw"], "LDC2010T04", "fisher_spa",
                          "data", "speech")
    for rec in sorted({k.split("-")[0] for k in gt}):
        samples, _ = read_audio(os.path.join(speech, f"{rec}.sph"),
                                sample_rate=16000)
        write_wav(os.path.join(base, "wavs", f"{rec}.wav"), samples, 16000)
    written = _run_in_turn(str(prepared["root"] / f"seg_{method}"),
                           _segment(base, method))
    assert sorted(written["port"]) == sorted(written["jax"])
    assert any(p.startswith("resegmented") for p in written["jax"])
    for path, data in written["jax"].items():
        assert written["port"][path] == data, path


def test_turns_driver_merges_the_mixtures(prepared, tmp_path):
    """The port's driver (the JAX driver's flags) over the same tree: its
    per-split manifests equal the ones prepared above, and the mixture is
    the union of its parts with the joint field."""
    tree = prepared["tree"]
    out = str(tmp_path / "out")
    run_data_preparation_turns.main(["--raw", tree["raw"], "--out", out,
                                     "--corpus", tree["corpus"],
                                     "--max-seconds", "30"])
    with open(os.path.join(out, "train-30s", "data-turns-st.json")) as f:
        part = json.load(f)
    ref = prepared["written"]["jax"][os.path.join("train-30s",
                                                  "data-turns-st.json")]
    assert part == json.loads(ref.decode().replace(prepared["out"], out))
    with open(os.path.join(out, "fisher-callhome-train-30s",
                           "data-turns-asr-st.json")) as f:
        mix = json.load(f)
    assert set(part) <= set(mix)
    assert all("transcription_and_translation" in e for e in mix.values())


def _random_texts(seed, n):
    rng = np.random.default_rng(seed)
    alphabet = (list("abcxyzABZ059 ñáéüÁ¿¡'\".,;:!?()[]{}<>-–—«»“”„‘’´`…%$€&|"
                     "/@#*+=_\t\n\r ")
                + ["...", "Mr. ", "No. 5", "e.g. ", "cannot ", "it's ",
                   "1,000 ", "S.A. ", "etc. ", "'s ", "n't ", "nº "])
    return ["".join(rng.choice(alphabet, int(rng.integers(0, 40))))
            for _ in range(n)]


@pytest.mark.parametrize("lang", ["en", "es"])
def test_moses_stages_match_sacremoses(lang):
    import sacremoses

    norm, tok = moses.MosesPunctNormalizer(lang), moses.MosesTokenizer(lang)
    ref_norm = sacremoses.MosesPunctNormalizer(lang=lang)
    ref_tok = sacremoses.MosesTokenizer(lang=lang)
    for text in _random_texts(7 if lang == "en" else 8, 400):
        assert norm.normalize(text) == ref_norm.normalize(text), text
        assert tok.tokenize(text) == ref_tok.tokenize(text), text
    with pytest.raises(ValueError, match="lang"):
        moses.MosesTokenizer("fr")
