"""Datasets and padded batches (port of ``stac_st_tpu/data/dataset.py``).

* :class:`SpeechDataset` — one sample per manifest entry: the (possibly
  multi-file) ``wav`` field read and concatenated at the dataset's rate,
  host speed perturbation or the device one's keyed ``speed_idx``, and the
  prompt-prefixed token variants (``[src][tgt]`` + BPE ids, bos/eos);
* :func:`sort_ids` — the ascending/descending/random index orders;
* :class:`PaddedBatch` — the reference's batch (``batch.sig`` ->
  ``(data, rel_lengths)``);
* :func:`collate_batch` pads samples to static shapes (audio to a bucket
  boundary, token arrays to a multiple); :func:`pad_batch_rows` pads the
  batch dimension with zero-length rows.

Host-side numpy throughout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .audio import read_audio
from .manifest import load_manifest, wav_paths
from .text import build_target_ids

__all__ = ["SpeechDataset", "PaddedBatch", "collate_batch", "sort_ids",
           "pad_batch_rows"]


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


class SpeechDataset:
    """Index-addressable dataset over a JSON manifest."""

    def __init__(
        self,
        json_path: str,
        tokenizer,
        sample_rate: int = 16000,
        replacements: Optional[Dict[str, str]] = None,
        speed_perturb=None,
        bos_index: int = 1,
        eos_index: int = 2,
        include_xt: bool = True,
        include_turn: bool = True,
        text_keys: Sequence[str] = (
            "transcription", "translation_0", "translation_1",
            "translation_2", "translation_3",
        ),
    ):
        self.data = load_manifest(json_path, replacements)
        self.ids = list(self.data.keys())
        self.tokenizer = tokenizer
        self.sample_rate = int(sample_rate)
        self.speed_perturb = speed_perturb
        self.bos_index = bos_index
        self.eos_index = eos_index
        self.include_xt = include_xt
        self.include_turn = include_turn
        self.text_keys = tuple(text_keys)
        # epoch feeds the per-utterance speed-perturb key (loader
        # set_epoch keeps it current) so speeds redraw each epoch yet
        # stay invariant to decode order, worker count, and host count
        self.epoch = 0

    # ------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return len(self.ids)

    def durations(self) -> np.ndarray:
        return np.asarray(
            [float(self.data[i].get("duration", 0.0)) for i in self.ids]
        )

    def entry(self, index: int) -> Dict[str, Any]:
        return self.data[self.ids[index]]

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.sample(index)

    def sample(self, index: int, skip_audio: bool = False,
               audio_cap: Optional[int] = None) -> Dict[str, Any]:
        """One sample; ``skip_audio=True`` replaces the (expensive) audio
        decode with a zero waveform of the manifest-duration length
        (speed-perturb-scaled when perturb is active, else capped at
        ``audio_cap`` samples) — used by shard-aware loaders on
        multi-process runs, where a process only needs real audio for its
        own row block. Everything else about the sample — tokens, text
        references, metadata, and the per-utterance speed draw (keyed
        by (epoch, row), not drawn from a sequential stream) — is
        computed identically, so batch composition matches the
        unsharded run regardless of host/worker count."""
        utt_id = self.ids[index]
        entry = self.data[utt_id]
        # per-utterance speed draw, keyed by (epoch, row) so every
        # process/worker computes the SAME speed for a row whether or
        # not it decodes the audio (multi-host composition parity)
        key = (self.epoch, index)
        host_perturb = self.speed_perturb is not None and not getattr(
            self.speed_perturb, "device", False
        )
        speed = self.speed_perturb.speed_for(key) if host_perturb else None
        if skip_audio and "duration" in entry:
            n = int(round(float(entry["duration"]) * self.sample_rate))
            if speed is not None:
                # stand-in length must match the owning host's REAL
                # perturbed length, or padded widths desync across hosts
                n = self.speed_perturb.perturbed_len(n, speed)
            elif audio_cap is not None:
                n = min(n, int(audio_cap))
            sig = np.zeros((max(n, 1),), np.float32)
        else:
            sig = self._load_audio(entry, speed=speed)
        sample: Dict[str, Any] = {
            "id": utt_id,
            "sig": sig,
            "duration": float(entry.get("duration",
                                        len(sig) / self.sample_rate)),
            "task": entry.get("task", ""),
            "source_lang": entry.get("source_lang", ""),
            "target_lang": entry.get("target_lang", ""),
        }
        if self.speed_perturb is not None and getattr(
            self.speed_perturb, "device", False
        ):
            # device-side perturb: host only samples the speed (keyed,
            # same order-invariance contract as the host path)
            sample["speed_idx"] = self.speed_perturb.index_for(key)
        if self.tokenizer is not None:
            sample.update(
                build_target_ids(
                    entry, self.tokenizer, self.bos_index, self.eos_index,
                    self.include_xt, self.include_turn,
                )
            )
        for key in self.text_keys:
            if key in entry:
                sample[key] = entry[key]
        return sample

    def _load_audio(self, entry: Dict[str, Any],
                    speed: Optional[int] = None) -> np.ndarray:
        parts = [
            read_audio(p, sample_rate=self.sample_rate)[0]
            for p in wav_paths(entry)
        ]
        sig = parts[0] if len(parts) == 1 else np.concatenate(parts)
        if self.speed_perturb is not None and not getattr(
            self.speed_perturb, "device", False
        ):
            # speed comes from sample()'s keyed draw; None only on
            # direct _load_audio calls (legacy sequential draw)
            sig = self.speed_perturb(sig, speed=speed)
        return np.asarray(sig, np.float32)


def sort_ids(dataset: SpeechDataset, sorting: str) -> List[int]:
    """ascending/descending/random index order (dataio_and_utils.py:175-200)."""
    durs = dataset.durations()
    if sorting == "ascending":
        return list(np.argsort(durs, kind="stable"))
    if sorting == "descending":
        return list(np.argsort(-durs, kind="stable"))
    if sorting == "random":
        return list(range(len(dataset)))
    raise NotImplementedError(
        "sorting must be random, ascending or descending"
    )


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
