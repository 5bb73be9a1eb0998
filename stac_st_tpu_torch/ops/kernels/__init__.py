"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is a shared library with a plain C interface,
compiled at first use with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into ``build/torch_kernels/`` at the repository root (named by the hash of
its source and flags, so an edited source is never served stale) and
loaded with ``ctypes``. Nothing is compiled when a module is imported.
Each build's nvcc output (``-Xptxas -v``: registers, spills) is kept
beside its library, so ``build_logs`` holds it for a cached build too.

``launches`` counts kernel launches by name: a wrapper adds one exactly
where it launches its kernel, never for its plain PyTorch version, so a run
can show that its path went through the kernels.

Serving launches kernels from several threads at once (the front end's
worker, the slot loop, the finalizer), so the counts change under a lock,
and each library is built and loaded once under a lock of its own (its
nvcc output goes to a temporary file named by process and thread).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["launches", "reset_launches", "count_launch", "load_library",
           "build", "build_logs", "CSRC_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Dict[str, int] = {}
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_build_lock = threading.RLock()  # build() runs inside load_library


def count_launch(name: str) -> None:
    with _count_lock:
        launches[name] = launches.get(name, 0) + 1


def reset_launches() -> None:
    with _count_lock:
        launches.clear()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that has no current build, all nvcc
    processes started together. Returns seconds per compiled name."""
    with _build_lock:
        return _build(names)


def _build(names: Iterable[str]) -> Dict[str, float]:
    todo = []
    for n in names:
        if _target(n).exists():
            log = _target(n).with_suffix(".log")
            build_logs[n] = log.read_text() if log.exists() else ""
        else:
            todo.append(n)
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            _target(name).with_suffix(".log").write_text(out)
            os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _build_lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib
