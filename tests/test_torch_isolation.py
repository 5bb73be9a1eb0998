"""The port stands alone: it pulls in no JAX and nothing of the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import functools
import json
import os
import re
import subprocess
import sys

import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu_torch import device as port_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Imports every module of the port, then resolves every
# recipes/hparams/transformer_*.yaml through the port's config loader at a
# tiny size (and a YAML naming the JAX package's DeviceSpeedPerturb), and
# reports the modules imported, the constructed objects whose class is not
# the port's, and any JAX or JAX-package module in sys.modules.
_IMPORT_ALL = r"""
import functools, glob, importlib, json, pkgutil, sys, tempfile, types
import yaml
import stac_st_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from stac_st_tpu_torch.config import load_hyperpyyaml
from stac_st_tpu_torch.config.hyperyaml import Placeholder, _Loader

TINY = {"d_model": 32, "nhead": 4, "num_encoder_layers": 2,
        "num_decoder_layers": 2, "d_ffn": 64, "output_neurons": 150}
SCALARS = (int, float, str, bool, type(None))

def foreign(value, where, out):
    if isinstance(value, dict):
        for k, v in value.items():
            foreign(v, f"{where}.{k}", out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            foreign(v, f"{where}[{i}]", out)
    elif not isinstance(value, SCALARS):
        obj = value.func if isinstance(value, functools.partial) else value
        mod = (obj.__module__ if isinstance(obj, (type, types.FunctionType))
               else type(obj).__module__)
        if not mod.startswith("stac_st_tpu_torch."):
            out.append(f"{where}: {mod}")

tmp = tempfile.mkdtemp()
yamls, found = sorted(glob.glob("recipes/hparams/transformer_*.yaml")), []
for path in yamls:
    text = open(path).read()
    raw = yaml.load(text, Loader=_Loader)
    ov = {k: v for k, v in TINY.items() if k in raw}
    ov.update({k: f"{tmp}/{k}" for k, v in raw.items()
               if isinstance(v, Placeholder) or k == "output_folder"})
    foreign(load_hyperpyyaml(text, ov), path, found)
sp = load_hyperpyyaml(
    "sp: !new:stac_st_tpu.ops.speed_perturb.DeviceSpeedPerturb\n"
    "    speeds: [90, 100, 110]\n")["sp"]
try:
    load_hyperpyyaml("x: !new:stac_st_tpu.ops.speed_perturb.NoSuchName\n")
    missing = "resolved"
except ImportError as err:
    missing = str(err)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or m == "stac_st_tpu" or m.startswith("stac_st_tpu."))
lazy = sorted({m.split(".")[0] for m in sys.modules}
              & {"transformers", "pyannote"})
print(json.dumps({"modules": len(names), "names": names, "bad": bad,
                  "lazy": lazy,
                  "yamls": len(yamls),
                  "foreign": found, "missing": missing,
                  "device_speed_perturb": f"{type(sp).__module__}."
                                          f"{type(sp).__qualname__}"}))
"""


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def imported_all():
    """One subprocess: every module imported and every YAML resolved."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


# the serving front's modules, int8 / speculative decoding's, data
# parallelism's, and the native library's, the corpus preparation's, the
# SpeechBrain bridge's, the other corpora's and the baselines', which the
# import-all subprocess must reach
SERVING_MODULES = ("serving_stream", "serving_http", "serving_continuous",
                   "recipes.serve", "prep.shas", "eval.long_form",
                   "utils.quantize", "decoding.speculative",
                   "parallel.distributed", "parallel.mesh", "native",
                   "prep.records", "prep.turns", "prep.tdf", "prep.cleaning",
                   "prep.audio_prep", "prep.segmentation", "prep.fisher",
                   "prep.callhome", "utils.moses", "examples.ldc_tree",
                   "interop.sb_import", "interop.sb_export",
                   "tools.import_sb_ckpt", "tools.export_sb_ckpt",
                   "datasets.fisher_callhome.run_data_preparation",
                   "datasets.fisher_callhome.run_data_preparation_turns",
                   "datasets.fisher_callhome.run_segmentation",
                   "prep.mixing", "prep.covost", "prep.mslt",
                   "examples.corpora_tree",
                   "datasets.covost2.run_prepare_covost2",
                   "datasets.mslt.run_prepare_mslt",
                   "datasets.cross_datasets_experiments."
                   "prepare_cross_datasets",
                   "eval.pyannote_local", "eval.pyannote_baseline",
                   "eval.whisper_baseline",
                   "evaluations.pyannote.run_pyannote_baseline",
                   "evaluations.whisper.run_whisper_baseline")


def test_importing_every_module_pulls_in_no_jax(imported_all):
    # every module of the package was imported, the serving front's too
    assert imported_all["modules"] >= 118
    for name in SERVING_MODULES:
        assert f"stac_st_tpu_torch.{name}" in imported_all["names"]
    assert imported_all["bad"] == []
    # the baselines import transformers and pyannote inside their
    # functions only
    assert imported_all["lazy"] == []


def test_yaml_resolution_builds_only_port_objects(imported_all):
    """Every transformer YAML of the repository resolves to the port's
    classes and functions only, without importing JAX or the JAX package;
    a path into the JAX package resolves to the port's counterpart, or
    raises ImportError naming it."""
    assert imported_all["yamls"] == 6
    assert imported_all["foreign"] == []
    assert imported_all["device_speed_perturb"] == (
        "stac_st_tpu_torch.ops.speed_perturb.DeviceSpeedPerturb")
    assert "stac_st_tpu.ops.speed_perturb.NoSuchName" in \
        imported_all["missing"]
    assert imported_all["bad"] == []


# what the port never imports, at module level or inside a function (the
# import-all check above sees only what importing runs)
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stac_st_tpu", "_stacnative",
              "_stacaudio")
_DYNAMIC = re.compile(r"(import_module|__import__)\(\s*[\"']("
                      + "|".join(_FORBIDDEN) + r")(\.|[\"'])")


def _imports(tree, package=""):
    """(line, module) of every import statement in the tree; a relative
    import is resolved against ``package``, the package of the file."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")[:len(package.split("."))
                                             - node.level + 1]
                yield node.lineno, ".".join(parts + ([node.module]
                                                     if node.module else []))
            else:
                yield node.lineno, node.module or ""


@functools.lru_cache(maxsize=None)
def _sources():
    """(path relative to the repository, source, its imports) of
    chip_smoke.py and of every module of the port, parsed once."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "stac_st_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    out = []
    for path in files:
        src = open(path, encoding="utf-8").read()
        rel = os.path.relpath(path, ROOT)
        package = ".".join(rel.split(os.sep)[:-1])
        out.append((rel, src, list(_imports(ast.parse(src, path), package))))
    return out


def test_no_source_imports_jax_or_the_jax_package_anywhere():
    found = []
    for rel, src, imports in _sources():
        found += [f"{rel}:{line} {mod}" for line, mod in imports
                  if mod.split(".")[0] in _FORBIDDEN]
        found += [f"{rel}: {m.group(0)}" for m in _DYNAMIC.finditer(src)]
    assert len(_sources()) >= 50
    assert found == []


def test_no_source_names_the_jax_packages_native_extensions():
    """The port builds and loads its own native library (``native.py``);
    no source names the JAX package's extensions, so none can load them
    or copy the loader that falls back without saying so."""
    found = [f"{rel}:{src[:m.start()].count(chr(10)) + 1}"
             for rel, src, _ in _sources()
             for m in re.finditer(r"_stac(native|audio)", src)]
    assert found == []


# packages the card's environment does not have (the port keeps its own
# BLEU, detokenizer, tokenizer and audio readers)
_NOT_ON_THE_CARD = ("sacrebleu", "sacremoses", "sentencepiece", "soundfile")


def test_no_source_imports_a_package_the_card_lacks():
    found = [f"{rel}:{line} {mod}" for rel, _, imports in _sources()
             if rel.startswith("stac_st_tpu_torch")
             for line, mod in imports
             if mod.split(".")[0] in _NOT_ON_THE_CARD]
    assert found == []


def test_the_source_check_sees_lazy_imports():
    src = ("def f():\n    import jax.numpy as jnp\n"
           "    from stac_st_tpu.data import audio\n"
           "    import _stacnative\n"
           "    from ..native import BpeVocab\n"
           "    from .. import native\n"
           "    from stac_st_tpu_torch.data import audio\n")
    found = [m for _, m in _imports(ast.parse(src), "stac_st_tpu_torch.data")]
    assert found == ["jax.numpy", "stac_st_tpu.data", "_stacnative",
                     "stac_st_tpu_torch.native", "stac_st_tpu_torch",
                     "stac_st_tpu_torch.data"]
    assert [m.split(".")[0] in _FORBIDDEN for m in found] == [
        True, True, True, False, False, False]
    assert _DYNAMIC.search('importlib.import_module("jax")')
    assert _DYNAMIC.search("__import__('stac_st_tpu.ops')")
    assert not _DYNAMIC.search('import_module("stac_st_tpu_torch.ops")')


def _tiny_engine_parts():
    from stac_st_tpu_torch.models import (
        ConvolutionFrontEnd,
        LinearHead,
        TransformerMultiTask,
    )
    from stac_st_tpu_torch.ops.cmvn import cmvn_init

    tr = TransformerMultiTask(20, 20 * 4, d_model=16, nhead=2,
                              num_encoder_layers=1, num_decoder_layers=1,
                              d_ffn=16)
    return (tr, ConvolutionFrontEnd(out_channels=(4, 4)), LinearHead(16, 20),
            LinearHead(16, 20), cmvn_init(80), None)


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from stac_st_tpu_torch.serving import STEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        STEngine(*_tiny_engine_parts())
    with pytest.raises(RuntimeError, match="cuda"):
        STEngine(*_tiny_engine_parts(), device="cuda")
    engine = STEngine(*_tiny_engine_parts(), device="cpu")
    assert engine.device.type == "cpu"


def test_serving_front_runs_on_cuda_unless_asked(monkeypatch):
    """The serve recipe asks for ``cuda`` unless ``--device cpu`` is given;
    the continuous engine and the HTTP front run on their engine's device,
    which raises without CUDA."""
    from stac_st_tpu_torch.recipes import serve

    assert serve.build_parser().parse_args(["exp"]).device == "cuda"
    assert serve.build_parser().parse_args(
        ["exp", "--device", "cpu"]).device == "cpu"
    from stac_st_tpu_torch.serving import STEngine

    from stac_st_tpu_torch.serving_continuous import (
        ContinuousBatchingEngine,
    )

    cont = ContinuousBatchingEngine(
        STEngine(*_tiny_engine_parts(), device="cpu",
                 bucket_seconds=(0.5,)), slots=1, chunk=1)
    try:
        assert cont._states[0]["pos"].device.type == "cpu"
        assert cont._states[0]["layers"][0]["self"]["k"].device.type == "cpu"
    finally:
        cont.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        STEngine(*_tiny_engine_parts(), device=serve.build_parser()
                 .parse_args(["exp"]).device)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.resolve_device() == torch.device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
