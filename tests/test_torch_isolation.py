"""The port stands alone: it pulls in no JAX and nothing of the JAX package,
and its entry points run on CUDA unless the caller asks for the CPU."""

import os
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
    assert int(n) >= 15  # every module of the package was imported
    assert bad == "[]", bad


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
