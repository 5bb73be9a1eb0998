"""The port stands alone: it pulls in no JAX and nothing of the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

from stac_st_tpu_torch import device as port_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import stac_st_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
             or m == "stac_st_tpu" or m.startswith("stac_st_tpu."))
print(len(names), bad)
"""


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_importing_every_module_pulls_in_no_jax():
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 49  # every module of the package was imported
    assert bad == "[]", bad


# what the port never imports, at module level or inside a function (the
# import-all check above sees only what importing runs)
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stac_st_tpu", "_stacnative",
              "_stacaudio")
_DYNAMIC = re.compile(r"(import_module|__import__)\(\s*[\"']("
                      + "|".join(_FORBIDDEN) + r")(\.|[\"'])")


def _imports(tree):
    """(line, module) of every import statement in the tree; a relative
    import of the JAX package's native loader counts as ``_stacnative``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level and (node.module or "").split(".")[-1] == "native":
                yield node.lineno, "_stacnative"
            elif not node.level:
                yield node.lineno, node.module or ""


def test_no_source_imports_jax_or_the_jax_package_anywhere():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "stac_st_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    found = []
    for path in files:
        src = open(path, encoding="utf-8").read()
        rel = os.path.relpath(path, ROOT)
        found += [f"{rel}:{line} {mod}" for line, mod in
                  _imports(ast.parse(src, path))
                  if mod.split(".")[0] in _FORBIDDEN]
        found += [f"{rel}: {m.group(0)}" for m in _DYNAMIC.finditer(src)]
    assert len(files) >= 50
    assert found == []


def test_the_source_check_sees_lazy_imports():
    src = ("def f():\n    import jax.numpy as jnp\n"
           "    from stac_st_tpu.data import audio\n"
           "    from ..native import get_native\n"
           "    from stac_st_tpu_torch.data import audio\n")
    assert [m for _, m in _imports(ast.parse(src))] == [
        "jax.numpy", "stac_st_tpu.data", "_stacnative", "stac_st_tpu_torch.data"]
    assert [m.split(".")[0] in _FORBIDDEN for _, m in
            _imports(ast.parse(src))] == [True, True, True, False]
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


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.resolve_device() == torch.device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")
