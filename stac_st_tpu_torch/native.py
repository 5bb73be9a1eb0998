"""The port's native host runtime: ``csrc/stacnative.cpp`` through ctypes.

The library holds the host loops the data path runs for every utterance:
the PCM16, µ-law and A-law byte decoders (``data/audio.py``), the BPE
merge loop (``tokenizer/bpe.py``), plus a polyphase resampler and the
word-level edit-distance core, which no path calls yet.

It is compiled at first use with the host C++ compiler (``g++ -O3
-shared -fPIC``, the compiler ``nvcc`` itself drives) into
``build/torch_kernels/`` at the repository root, named by the hash of its
source and flags as the CUDA libraries are (``ops/kernels``). The
compiler writes to a file named by process and thread, renamed into
place, so processes building at once leave one whole library. The
compiler's output is kept beside it. A failed build raises with that
output: nothing falls back to the numpy versions, which stay as the
plain versions the tests hold the library to (``data/audio.py``
``_*_bytes_plain``, ``BpeEncoder._bpe_segment_plain``, scipy's
``resample_poly``, ``utils.edit_distance.align_edit_distance``).

ctypes releases the interpreter lock for the length of each call, so
loader threads decode and tokenize in parallel.
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
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ops.kernels import BUILD_DIR, CSRC_DIR

__all__ = ["SOURCE", "CXX_FLAGS", "target", "build", "library",
           "build_seconds", "pcm16_to_float", "ulaw_to_float", "alaw_to_float",
           "resample_poly", "edit_stats", "BpeVocab"]

SOURCE = CSRC_DIR / "stacnative.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None  # of this process's build, if any

_u8 = ctypes.POINTER(ctypes.c_uint8)
_f32 = ctypes.POINTER(ctypes.c_float)
_f64 = ctypes.POINTER(ctypes.c_double)
_i32 = ctypes.POINTER(ctypes.c_int32)
_i64 = ctypes.c_int64


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH)")


def target(directory: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return Path(directory) / f"libstacnative-{digest[:16]}.so"


def build(directory: Path = BUILD_DIR) -> Path:
    """The library's path under ``directory``, compiled first if it is
    not there. Raises ``RuntimeError`` with the compiler's output."""
    global build_seconds
    lib = target(directory)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}")
    log = tmp.with_suffix(".log.tmp")
    log.write_text(proc.stdout)
    os.replace(log, lib.with_suffix(".log"))
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    sigs = {
        "stac_pcm16_to_float": (None, [_u8, _i64, ctypes.c_int, _f32]),
        "stac_ulaw_to_float": (None, [_u8, _i64, _f32]),
        "stac_alaw_to_float": (None, [_u8, _i64, _f32]),
        "stac_resample_poly_len": (_i64, [_i64, ctypes.c_int, ctypes.c_int]),
        "stac_resample_poly": (None, [_f32, _i64, ctypes.c_int, ctypes.c_int,
                                      _f32]),
        "stac_edit_stats": (None, [_i32, _i64, _i32, _i64, _i32]),
        "stac_bpe_load": (ctypes.c_void_p,
                          [ctypes.POINTER(ctypes.c_char_p), _f64, _i64]),
        "stac_bpe_free": (None, [ctypes.c_void_p]),
        "stac_bpe_encode": (_i64, [ctypes.c_void_p, ctypes.c_char_p, _i64,
                                   ctypes.c_int, _i32]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _bytes_in(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


# ------------------------------------------------------------------ audio
def pcm16_to_float(data: bytes, big_endian: bool = False) -> np.ndarray:
    """Little- (or big-) endian int16 bytes -> float32 samples / 32768."""
    src = _bytes_in(data)
    out = np.empty(len(src) // 2, np.float32)
    library().stac_pcm16_to_float(_ptr(src, ctypes.c_uint8), len(out),
                                  int(big_endian), _ptr(out, ctypes.c_float))
    return out


def ulaw_to_float(data: bytes) -> np.ndarray:
    src = _bytes_in(data)
    out = np.empty(len(src), np.float32)
    library().stac_ulaw_to_float(_ptr(src, ctypes.c_uint8), len(out),
                                 _ptr(out, ctypes.c_float))
    return out


def alaw_to_float(data: bytes) -> np.ndarray:
    src = _bytes_in(data)
    out = np.empty(len(src), np.float32)
    library().stac_alaw_to_float(_ptr(src, ctypes.c_uint8), len(out),
                                 _ptr(out, ctypes.c_float))
    return out


def resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """One channel of float32 resampled by ``up / down`` (Kaiser-windowed
    sinc, scipy's filter family; not bitwise scipy's)."""
    if up < 1 or down < 1:
        raise ValueError(f"resample_poly: up={up}, down={down}; both >= 1")
    x = np.ascontiguousarray(x, np.float32)
    lib = library()
    out = np.empty(lib.stac_resample_poly_len(len(x), up, down), np.float32)
    lib.stac_resample_poly(_ptr(x, ctypes.c_float), len(x), up, down,
                           _ptr(out, ctypes.c_float))
    return out


# ---------------------------------------------------------- edit distance
def edit_stats(ref: Sequence[str], hyp: Sequence[str]
               ) -> Tuple[int, int, int]:
    """(insertions, deletions, substitutions) of a minimal word alignment;
    their sum is the edit distance (the split may differ from
    ``align_edit_distance``'s where alignments tie)."""
    ids: dict = {}
    r = np.array([ids.setdefault(w, len(ids)) for w in ref], np.int32)
    h = np.array([ids.setdefault(w, len(ids)) for w in hyp], np.int32)
    out = np.zeros(3, np.int32)
    library().stac_edit_stats(_ptr(r, ctypes.c_int32), len(r),
                              _ptr(h, ctypes.c_int32), len(h),
                              _ptr(out, ctypes.c_int32))
    return int(out[0]), int(out[1]), int(out[2])


# ------------------------------------------------------------------- BPE
class BpeVocab:
    """A BPE vocabulary held by the library: ``encode`` runs the merge loop
    of one normalized segment (no user-defined symbol inside)."""

    def __init__(self, pieces: Sequence[str], scores: Sequence[float]):
        self._lib = library()
        raw = [p.encode("utf-8") for p in pieces]
        arr = (ctypes.c_char_p * len(raw))(*raw)
        sc = np.ascontiguousarray(scores, np.float64)
        self._handle = self._lib.stac_bpe_load(arr, _ptr(sc, ctypes.c_double),
                                               len(raw))

    def encode(self, segment: str, unk_id: int) -> List[int]:
        data = segment.encode("utf-8")
        out = np.empty(len(data), np.int32)
        n = self._lib.stac_bpe_encode(self._handle, data, len(data), unk_id,
                                      _ptr(out, ctypes.c_int32))
        return out[:n].tolist()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.stac_bpe_free(handle)
            self._handle = None
