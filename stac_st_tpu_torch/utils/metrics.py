"""Evaluation metric accumulators (BLEU / WER / token accuracy); copy of
``stac_st_tpu/utils/metrics.py``.

API-compatible with the SpeechBrain stats objects the reference instantiates
from YAML (``transformer_multitask.yaml:308-311``) and drives in
``train_multitask.py:373-401,433-449`` / ``dataio_and_utils.py:248-287``:

* :class:`BLEUStats` — corpus BLEU with up to 4 references (sacrebleu's
  defaults, computed by the port's own ``utils.bleu``),
  exposing ``.ids``, ``.predicts``, ``.targets`` and ``write_stats``;
* :class:`ErrorRateStats` — WER with per-utterance alignments and the
  standard stats-file layout, exposing ``.scores``/``.ids``;
* :class:`AccuracyStats` — teacher-forced token accuracy over masked
  positions (the checkpoint-selection key, ``train_multitask.py:420-424``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .bleu import corpus_bleu
from .edit_distance import wer_details

__all__ = ["BLEUStats", "ErrorRateStats", "AccuracyStats"]


class BLEUStats:
    def __init__(self, lang: str = "en", merge_words: bool = False, **unused):
        self.ids: List[str] = []
        self.predicts: List[str] = []
        self.targets: List[List[str]] = []  # [ref_stream][utt]
        self._summary: Optional[Dict] = None

    def append(self, ids, predict, targets) -> None:
        """ids: [utt]; predict: [utt str]; targets: [ref_stream][utt str]."""
        self.ids.extend(ids)
        self.predicts.extend(predict)
        if not self.targets:
            self.targets = [list(t) for t in targets]
        else:
            if len(targets) != len(self.targets):
                raise ValueError("inconsistent number of reference streams")
            for stream, new in zip(self.targets, targets):
                stream.extend(new)
        self._summary = None

    def summarize(self, field: Optional[str] = None):
        if self._summary is None:
            if not self.predicts:
                self._summary = {"BLEU": 0.0}
            else:
                bleu = corpus_bleu(self.predicts, self.targets)
                self._summary = {
                    "BLEU": bleu.score,
                    "BP": bleu.bp,
                    "ratio": bleu.sys_len / max(bleu.ref_len, 1),
                    "sys_len": bleu.sys_len,
                    "ref_len": bleu.ref_len,
                    "precisions": bleu.precisions,
                }
        if field is not None:
            return self._summary.get(field, 0.0)
        return self._summary

    def write_stats(self, filestream) -> None:
        s = self.summarize()
        filestream.write(f"BLEU: {s['BLEU']:.2f}\n")
        for k in ("BP", "ratio", "sys_len", "ref_len"):
            if k in s:
                filestream.write(f"{k}: {s[k]}\n")
        if "precisions" in s:
            filestream.write(
                "precisions: "
                + "/".join(f"{p:.1f}" for p in s["precisions"]) + "\n"
            )


class ErrorRateStats:
    def __init__(self, merge_tokens: bool = False, split_tokens: bool = False,
                 space_token: str = "_", **unused):
        self.ids: List[str] = []
        self.scores: List[Dict] = []

    def append(self, ids, predict, target, **unused) -> None:
        """ids: [utt]; predict/target: [utt][word]."""
        for key, hyp, ref in zip(ids, predict, target):
            self.ids.append(key)
            self.scores.append(wer_details(key, ref, hyp))

    def summarize(self, field: Optional[str] = None):
        tot_ref = sum(s["num_ref_tokens"] for s in self.scores)
        tot_edit = sum(s["num_edits"] for s in self.scores)
        tot_ins = sum(s["insertions"] for s in self.scores)
        tot_del = sum(s["deletions"] for s in self.scores)
        tot_sub = sum(s["substitutions"] for s in self.scores)
        summary = {
            "error_rate": 100.0 * tot_edit / max(tot_ref, 1),
            "WER": 100.0 * tot_edit / max(tot_ref, 1),
            "insertions": tot_ins,
            "deletions": tot_del,
            "substitutions": tot_sub,
            "num_ref_tokens": tot_ref,
            "num_edits": tot_edit,
            "num_scored_sents": len(self.scores),
        }
        if field is not None:
            return summary.get(field, 0.0)
        return summary

    def write_stats(self, filestream) -> None:
        s = self.summarize()
        filestream.write(
            "%WER {error_rate:.2f} [ {num_edits} / {num_ref_tokens}, "
            "{insertions} ins, {deletions} del, {substitutions} sub ]\n"
            "================================================================"
            "\n".format(**s)
        )
        for sc in self.scores:
            filestream.write(
                f"{sc['key']}, %WER {sc['WER']:.2f} "
                f"[ {sc['num_edits']} / {sc['num_ref_tokens']}, "
                f"{sc['insertions']} ins, {sc['deletions']} del, "
                f"{sc['substitutions']} sub ]\n"
            )
            ref_line, hyp_line = [], []
            for op, i, j in sc["alignment"]:
                r = sc["ref_tokens"][i] if i >= 0 else "<eps>"
                h = sc["hyp_tokens"][j] if j >= 0 else "<eps>"
                width = max(len(r), len(h))
                ref_line.append(r.ljust(width))
                hyp_line.append(h.ljust(width))
            filestream.write(" ; ".join(ref_line) + "\n")
            filestream.write(" ; ".join(hyp_line) + "\n")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AccuracyStats:
    """Token accuracy of teacher-forced predictions (argmax vs target)."""

    def __init__(self, **unused):
        self.correct = 0.0
        self.total = 0.0

    def append(self, log_probs, targets, length=None) -> None:
        """log_probs: (B, T, C); targets: (B, T); length: (B,) relative.
        Tensors or arrays; a tensor's argmax runs where it lies (the first
        maximum, as numpy's), and only the (B, T) predictions and the
        targets move to the host."""
        if not isinstance(log_probs, torch.Tensor):
            log_probs = np.asarray(log_probs)
        targets = _host(targets)
        T = min(log_probs.shape[1], targets.shape[1])
        pred = _host(log_probs[:, :T].argmax(-1))
        targets = targets[:, :T]
        if length is not None:
            length = _host(length)
            abs_len = np.round(length * T)
            mask = np.arange(T)[None, :] < abs_len[:, None]
        else:
            mask = np.ones_like(targets, dtype=bool)
        self.correct += float(((pred == targets) & mask).sum())
        self.total += float(mask.sum())

    def summarize(self, field: Optional[str] = None) -> float:
        return self.correct / max(self.total, 1.0)
