"""The port's CoVoST2 / MSLT preparation and cross-dataset mixing against
the JAX package's, on one seeded tree (``stac_st_tpu_torch/examples/
corpora_tree.py``: CommonVoice clips in Spanish and English with their
prepared manifests, CoVoST TSVs for es->en and en->de with a missing clip
and a two-word translation, an MSLT en->de tree of UTF-16 ``.snt`` files).

Both packages prepare into the same folder in turn, so every manifest is
compared byte for byte (paths inside included). The three port drivers run
through their ``main(argv)`` beside the JAX drivers. No JAX program is
built.
"""

import importlib.util
import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401  (this worker's share of the cores)
from torch_once import built_once

from stac_st_tpu.prep import covost as jcovost
from stac_st_tpu.prep import mixing as jmixing
from stac_st_tpu.prep import mslt as jmslt

from stac_st_tpu_torch.data.audio import read_audio
from stac_st_tpu_torch.data.dataset import SpeechDataset
from stac_st_tpu_torch.datasets.covost2 import run_prepare_covost2
from stac_st_tpu_torch.datasets.cross_datasets_experiments import (
    prepare_cross_datasets,
)
from stac_st_tpu_torch.datasets.fisher_callhome import (
    run_data_preparation_turns,
)
from stac_st_tpu_torch.datasets.mslt import run_prepare_mslt
from stac_st_tpu_torch.examples.corpora_tree import make_corpora_tree
from stac_st_tpu_torch.prep import covost, mixing, mslt

PAIRS = ("es_en", "en_de")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree_bytes(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _in_turn(out, run):
    """``run(package, out)`` for the JAX package then the port into the
    same folder: ({package: files written}, {package: what run returned})."""
    written, returned = {}, {}
    for name in ("jax", "port"):
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        returned[name] = run(name, out)
        written[name] = _tree_bytes(out)
    return written, returned


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _build(root):
    tree = make_corpora_tree(os.path.join(root, "raw"), n_clips=12,
                             n_mslt=5, seed=3)

    def prepare(name, out):
        cov, ms = (jcovost, jmslt) if name == "jax" else (covost, mslt)
        log = _Log()
        logger = logging.getLogger(cov.__name__)
        logger.addHandler(log)
        logger.setLevel(logging.INFO)
        try:
            outputs = {pair: cov.prepare_covost(
                tree["tsv"][pair], tree["cv_all"][pair.split("_")[0]],
                out, *pair.split("_")) for pair in PAIRS}
        finally:
            logger.removeHandler(log)
        return dict(covost=outputs, log=log.lines,
                    mslt=ms.prepare_mslt(tree["mslt"], out, "en", "de"))

    prepared = _in_turn(os.path.join(root, "prep"), prepare)
    covost_out = os.path.join(root, "covost_out")
    for pair in PAIRS:
        jcovost.prepare_covost(tree["tsv"][pair],
                               tree["cv_all"][pair.split("_")[0]],
                               covost_out, *pair.split("_"))
    st = os.path.join(covost_out, "covost_es_en", "train.json")
    cv = os.path.join(tree["cv"], "es", "train.json")

    def mix(name, out):
        m = jmixing if name == "jax" else mixing
        joined = m.join_json([cv, st], os.path.join(out, "joined.json"))
        turns = m.concat_json(os.path.join(out, "joined.json"),
                              os.path.join(out, "turns.json"),
                              max_seconds=20.0, seed=11)
        capped = m.concat_json(os.path.join(out, "joined.json"),
                               os.path.join(out, "capped.json"),
                               max_seconds=12.0, seed=5, max_samples=3)
        return dict(joined=len(joined), turns=len(turns),
                    capped=len(capped))

    mixed = _in_turn(os.path.join(root, "mix"), mix)
    return dict(tree=tree, prepared=prepared, mixed=mixed,
                covost_out=covost_out)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The tree and both packages' preparation of it, made once a run."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = tmp_path_factory.getbasetemp().parent / "torch_corpora"
    else:
        root = tmp_path_factory.mktemp("torch_corpora")
    return built_once(tmp_path_factory, "torch_corpora",
                      lambda: dict(_build(str(root)), root=str(root)))


def test_covost_and_mslt_manifests_are_byte_equal(corpora):
    (written, returned) = corpora["prepared"]
    assert sorted(written["port"]) == sorted(written["jax"])
    for path, data in written["jax"].items():
        assert written["port"][path] == data, path
    assert returned["port"]["log"] == returned["jax"]["log"]
    # one TSV clip a pair is in no manifest: skipped and counted
    for pair in PAIRS:
        assert f"covost {pair}: 1 TSV clips missing from the CV manifest" \
            in returned["port"]["log"]
    assert returned["port"]["covost"] == returned["jax"]["covost"]
    assert returned["port"]["mslt"] == returned["jax"]["mslt"]
    assert any(p.startswith("mslt_dev_en_de") for p in written["port"])


def test_covost_rows_gates_and_schema(corpora):
    """The two-word translation is gated; every row is an ST row carrying
    its CV entry; German keeps its accents."""
    out, tree = corpora["covost_out"], corpora["tree"]
    with open(tree["tsv"]["en_de"], encoding="utf-8") as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f][1:]
    with open(tree["cv_all"]["en"]) as f:
        cv = json.load(f)
    entries = {}
    for split in ("train", "dev", "test"):
        path = os.path.join(out, "covost_en_de", f"{split}.json")
        if os.path.isfile(path):
            with open(path) as f:
                entries.update(json.load(f))
    short = rows[0][0].split(".mp3")[0]
    assert len(rows[0][2].split()) == 2 and short not in entries
    assert len(entries) == len(rows) - 2  # the short row, the missing clip
    for key, e in entries.items():
        assert e["task"] == "translation" and e["target_lang"] == "de"
        assert e["wav"] == cv[key]["wav"]
        assert e["transcription"] == cv[key]["transcription"]
        assert len(e["translation_0"].split()) >= 3
    assert any(c in "".join(e["translation_0"] for e in entries.values())
               for c in "öü")


def test_mixing_is_byte_equal_at_one_seed(corpora):
    written, returned = corpora["mixed"]
    assert returned["port"] == returned["jax"]
    for path, data in written["jax"].items():
        assert written["port"][path] == data, path
    turns = json.loads(written["port"]["turns.json"])
    assert any(e["nb_turns"] > 0 for e in turns.values())
    for e in turns.values():
        n = len(e["wav"].split())
        assert e["nb_turns"] == n - 1 == e["transcription"].count("[turn]")
        assert e["duration"] <= 20.0
    assert len(json.loads(written["port"]["capped.json"])) == 3
    # the Fisher/CALLHOME turns driver merges with the same join_json
    assert run_data_preparation_turns.join_json is mixing.join_json


def _jax_driver(rel, argv):
    """``main()`` of a JAX driver script under ``datasets/`` with argv."""
    spec = importlib.util.spec_from_file_location(
        "jax_driver_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    old = sys.argv
    sys.argv = [rel] + list(argv)
    try:
        module.main()
    finally:
        sys.argv = old


def test_drivers_match_the_jax_drivers(corpora, tmp_path):
    """The three port drivers, through main(argv) with the JAX drivers'
    flags, write what the JAX drivers write into the same folders."""
    tree = corpora["tree"]

    def run(name, out):
        cov = os.path.join(out, "covost")
        for pair in PAIRS:
            src, tgt = pair.split("_")
            argv = ["--tsv", tree["tsv"][pair], "--cv", tree["cv_all"][src],
                    "--out", cov, "--src", src, "--tgt", tgt]
            if name == "jax":
                _jax_driver("datasets/covost2/run_prepare_covost2.py", argv)
            else:
                run_prepare_covost2.main(argv)
        argv = ["--data", tree["mslt"], "--out", os.path.join(out, "mslt"),
                "--src", "en", "--tgt", "de", "--subset", "dev"]
        if name == "jax":
            _jax_driver("datasets/mslt/run_prepare_mslt.py", argv)
        else:
            run_prepare_mslt.main(argv)
        argv = ["--cv", tree["cv"], "--covost", cov, "--out",
                os.path.join(out, "cross"), "--pairs", *PAIRS,
                "--multi-turn-seconds", "30"]
        if name == "jax":
            _jax_driver("datasets/cross_datasets_experiments/"
                        "prepare_cross_datasets.py", argv)
        else:
            prepare_cross_datasets.main(argv)

    written, _ = _in_turn(str(tmp_path / "out"), run)
    assert sorted(written["port"]) == sorted(written["jax"])
    for path, data in written["jax"].items():
        assert written["port"][path] == data, path
    names = set(written["port"])
    for tree_name in ("es_to_es.and.en", "en_to_en.and.de"):
        for f in ("data-asr-st.json", "data-turns-asr-st.json"):
            assert os.path.join("cross", tree_name, f) in names
    assert os.path.join("cross", "all_to_all", "data-asr-st.json") in names


def test_concat_entry_loads_as_the_concatenation_of_its_parts(corpora):
    """One SpeechDataset item of a concat_json entry (space-separated wav
    paths) is its parts' audio end to end."""
    written, _ = corpora["mixed"]
    path = os.path.join(corpora["root"], "mix", "turns.json")
    with open(path, "wb") as f:
        f.write(written["port"]["turns.json"])
    ds = SpeechDataset(path, None, sample_rate=16000)
    data = json.loads(written["port"]["turns.json"])
    i, (uid, entry) = next((i, kv) for i, kv in enumerate(data.items())
                           if kv[1]["nb_turns"] > 0)
    item = ds[i]
    assert item["id"] == uid
    parts = [read_audio(p, sample_rate=16000)[0]
             for p in entry["wav"].split()]
    np.testing.assert_array_equal(item["sig"], np.concatenate(parts))
    starts = [float(s) for s in entry["segments_start"].split()]
    assert starts == pytest.approx(
        np.concatenate([[0.0], np.cumsum([len(p) / 16000 for p in parts])
                        [:-1]]).tolist(), abs=1e-3)
