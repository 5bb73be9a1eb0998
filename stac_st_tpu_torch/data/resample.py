"""Fast polyphase resampler (BLAS-backed, cached filter banks; a copy of
``stac_st_tpu/data/resample.py``).

``scipy.signal.resample_poly`` redesigns its FIR filter on every call and
runs a generic C upfirdn loop, which makes resampling the loader's costliest
stage. This module keeps scipy's exact filter design (kaiser β=5.0, 10
zero-crossings per phase; ``tests/test_torch_data.py`` holds it to the JAX
package's copy, which its own tests hold to scipy) but:

* caches the designed filter, decomposed into an ``up``-phase bank, per
  (up, down) pair;
* evaluates the whole resample as one matrix product over a strided window
  view (BLAS instead of per-tap C);
* works in float32 end to end (audio dynamic range needs nothing more).

Used by the audio reader (8 kHz SPHERE → 16 kHz) and ``SpeedPerturb``; the
filter bank of :func:`_block_bank_c1` is also the weight of the device
resample (``ops/speed_perturb.py``).
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import Tuple

import numpy as np
from numpy.lib.stride_tricks import as_strided

__all__ = ["fast_resample_poly"]


@lru_cache(maxsize=128)
def _block_bank_c1(up: int, down: int):
    """scipy-identical filter → unchunked block filter matrix.

    Output t = b·up + p reads the contiguous window
    ``xp[b·down + s0 - (K-1) : … + K + down]`` and dots it with column p of
    the (K+down, up) matrix F — so a whole block of ``up`` outputs is one
    row of a GEMM (or one conv window of stride ``down`` — the on-device
    formulation in ops/speed_perturb.py).

    Returns (F (K+down, up), K, R, s0)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate  # scipy resample_poly default
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    h = (h * up).astype(np.float32)

    # scipy pads so the filter is centered and trims n_pre_remove outputs
    n_pre_pad = down - (half_len % down)
    H = np.concatenate([np.zeros(n_pre_pad, np.float32), h])
    R = (half_len + n_pre_pad) // down

    K = int(np.ceil(len(H) / up))
    # phase-p taps, reversed: out[t] = Σ_i f_p[i]·xp[start(t)+i], window
    # start(t) = (q//up) - (K-1), q = (t+R)·down, p = q % up
    fbank = np.zeros((up, K), np.float32)
    for p in range(up):
        taps = H[p::up]
        fbank[p, K - len(taps):] = taps[::-1]

    svals = [((p + R) * down) // up for p in range(up)]
    s0 = min(svals)
    F = np.zeros((K + down, up), np.float32)
    for p in range(up):
        d = svals[p] - s0  # 0..down
        q = (p + R) * down
        F[d: d + K, p] = fbank[q % up]
    return F, K, R, s0


@lru_cache(maxsize=128)
def _block_bank(up: int, down: int) -> Tuple[np.ndarray, int, int, int, int]:
    """Chunked variant for the host GEMM path: C blocks per GEMM row —
    wider rows amortize the window-copy (row width K+C·down covers C·up
    outputs) at the price of F-zeros. C minimizes copy-bytes/1e10 +
    MACs/1.5e10 (measured host rates). Returns (F, K, R, s0, C)."""
    F, K, R, s0 = _block_bank_c1(up, down)

    def cost(c):
        width = K + c * down
        rows_per_out = 1.0 / (c * up)
        return width * rows_per_out * (4 / 1e10 + up * c / 1.5e10)

    C = min(range(1, 65), key=cost)
    if C > 1:
        width = K + down + (C - 1) * down
        F2 = np.zeros((width, C * up), np.float32)
        for c in range(C):
            F2[c * down: c * down + K + down, c * up: (c + 1) * up] = F
        F = F2
    return F, K, R, s0, C


def fast_resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Drop-in for ``scipy.signal.resample_poly(x, up, down)`` (1-D)."""
    g = gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    x = np.ascontiguousarray(x, np.float32)
    n_in = len(x)
    if up == 1 and down == 1:
        return x.copy()
    n_out = n_in * up // down + bool((n_in * up) % down)

    F, K, R, s0, C = _block_bank(up, down)
    width = F.shape[0]
    n_rows = (n_out + C * up - 1) // (C * up)
    # window of GEMM row r starts at x[r·C·down + s0 - (K-1)]; pad so every
    # window is in range
    first = s0 - (K - 1)
    pad_lo = max(0, -first)
    pad_hi = max(
        0, (n_rows - 1) * C * down + first + width - n_in + pad_lo
    )
    xp = np.concatenate([
        np.zeros(pad_lo, np.float32), x, np.zeros(pad_hi, np.float32)
    ])
    itemsize = xp.itemsize
    W = as_strided(
        xp[pad_lo + first:],
        shape=(n_rows, width),
        strides=(C * down * itemsize, itemsize),
    )
    # materialize the window matrix: numpy's matmul on a strided view takes
    # a slow non-BLAS path (~14x slower than copy + sgemm)
    y = np.ascontiguousarray(W) @ F  # the entire resample as one GEMM
    return y.reshape(-1)[:n_out]
