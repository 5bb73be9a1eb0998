"""Fixed sinusoidal positional encodings (port of
``stac_st_tpu/models/positional.py``): pe[pos, 2i] = sin(pos / 10000^(2i/d)),
pe[pos, 2i+1] = cos(pos / 10000^(2i/d))."""

from __future__ import annotations

import numpy as np

__all__ = ["sinusoidal_table"]


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) float32 table."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    i = np.arange(0, d_model, 2, dtype=np.float64)[None, :]
    denom = np.power(10000.0, i / d_model)
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos / denom)
    pe[:, 1::2] = np.cos(pos / denom[:, : pe[:, 1::2].shape[1]])
    return pe.astype(np.float32)
