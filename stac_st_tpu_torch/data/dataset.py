"""Padded batches (port of the batch surface of
``stac_st_tpu/data/dataset.py``).

``PaddedBatch`` mimics the reference's batch (``batch.sig`` ->
``(data, rel_lengths)``), so the trainer takes the batches the JAX loader
yields; ``collate_batch`` pads a list of samples to static shapes (audio to
a bucket boundary, token arrays to a multiple); ``pad_batch_rows`` pads the
batch dimension with zero-length rows. Host-side numpy throughout. The
manifest loader, sampler and audio reading are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["PaddedBatch", "collate_batch", "pad_batch_rows"]


class _PaddedPair(tuple):
    """(data, relative_lengths) pair supporting tuple unpacking."""

    def __new__(cls, data, lengths):
        return super().__new__(cls, (data, lengths))

    @property
    def data(self):
        return self[0]

    @property
    def lengths(self):
        return self[1]


@dataclass
class PaddedBatch:
    """Attribute-style batch (reference PaddedBatch API)."""

    id: List[str]
    sig: _PaddedPair
    tokens: _PaddedPair
    tokens_bos: _PaddedPair
    tokens_eos: _PaddedPair
    duration: List[float]
    task: List[str]
    source_lang: List[str]
    target_lang: List[str]
    extras: Dict[str, List[Any]] = field(default_factory=dict)

    def __getattr__(self, name):
        extras = self.__dict__.get("extras", {})
        if name in extras:
            return extras[name]
        raise AttributeError(name)

    def __len__(self):
        return len(self.id)


def _pad_to(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


def collate_batch(samples: List[Dict[str, Any]],
                  audio_pad_samples: Optional[int] = None,
                  token_pad_multiple: int = 32,
                  batch_size_pad: Optional[int] = None) -> PaddedBatch:
    """Pad a list of samples into one static-shaped batch.

    audio_pad_samples: fixed audio width (bucket boundary); default the
      longest signal rounded up to 0.5 s, and a longer signal widens the
      batch to the 0.5 s grid;
    token_pad_multiple: token arrays padded to this multiple;
    batch_size_pad: right-pad the batch with repeats of the last sample.
    """
    B = len(samples)
    sigs = [s["sig"] for s in samples]
    max_sig = max(len(x) for x in sigs)
    width = audio_pad_samples or _pad_to(max_sig, 8000)
    if max_sig > width:
        width = _pad_to(max_sig, 8000)

    if "tokens" in samples[0]:
        tok = [np.asarray(s["tokens"], np.int32) for s in samples]
        tok_bos = [np.asarray(s["tokens_bos"], np.int32) for s in samples]
        tok_eos = [np.asarray(s["tokens_eos"], np.int32) for s in samples]
        U = _pad_to(max(len(t) for t in tok_eos), token_pad_multiple)
    else:
        tok = tok_bos = tok_eos = [np.zeros((1,), np.int32)] * B
        U = token_pad_multiple

    n_rows = batch_size_pad or B
    sig_arr = np.zeros((n_rows, width), np.float32)
    sig_len = np.zeros((n_rows,), np.float32)
    arrays = {name: (np.zeros((n_rows, U), np.int32),
                     np.zeros((n_rows,), np.float32))
              for name in ("tokens", "tokens_bos", "tokens_eos")}
    for i in range(n_rows):
        j = min(i, B - 1)
        sg = samples[j]["sig"]
        sig_arr[i, : len(sg)] = sg
        sig_len[i] = len(sg) / width
        for name, seqs in (("tokens", tok), ("tokens_bos", tok_bos),
                           ("tokens_eos", tok_eos)):
            data, lens = arrays[name]
            data[i, : len(seqs[j])] = seqs[j]
            lens[i] = len(seqs[j]) / U

    skip = ("id", "sig", "duration", "task", "source_lang", "target_lang",
            "tokens", "tokens_bos", "tokens_eos")
    extras = {key: [s.get(key) for s in samples]
              for key in samples[0] if key not in skip}
    return PaddedBatch(
        id=[s["id"] for s in samples],
        sig=_PaddedPair(sig_arr, sig_len),
        tokens=_PaddedPair(*arrays["tokens"]),
        tokens_bos=_PaddedPair(*arrays["tokens_bos"]),
        tokens_eos=_PaddedPair(*arrays["tokens_eos"]),
        duration=[s["duration"] for s in samples],
        task=[s["task"] for s in samples],
        source_lang=[s["source_lang"] for s in samples],
        target_lang=[s["target_lang"] for s in samples],
        extras=extras,
    )


def pad_batch_rows(arrays: Dict[str, np.ndarray],
                   multiple: int) -> Dict[str, np.ndarray]:
    """Right-pad the batch dim to a multiple with all-zero rows of zero
    relative length (they contribute nothing to the losses)."""
    B = next(iter(arrays.values())).shape[0]
    target = -(-B // multiple) * multiple
    if target == B:
        return arrays
    return {key: np.pad(np.asarray(v),
                        [(0, target - B)] + [(0, 0)] * (np.ndim(v) - 1))
            for key, v in arrays.items()}
