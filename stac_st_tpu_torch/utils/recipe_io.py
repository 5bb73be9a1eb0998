"""Recipe-level IO helpers: detokenized metric prep, CSV/RTTM writers
(copy of ``stac_st_tpu/utils/recipe_io.py``).

Re-owns the reference's ``dataio_and_utils`` output plumbing
(``stac-st/dataio_and_utils.py:248-464``): Moses detokenization per target
language, with/without ``[turn]``/``[xt]`` variants, 4-reference target
assembly, BLEU/WER stats files + `|`-separated CSVs, and the per-conversation
re-merge used by the long-form inference recipe (``:290-363``).
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Sequence, Tuple

from .detokenize import MosesDetokenizer

__all__ = [
    "get_detokenizer",
    "append_gt_preds",
    "append_4gt",
    "print_bleu_or_wer",
    "print_inference_output",
]

_DETOKENIZERS: Dict[str, object] = {}


def get_detokenizer(language: str):
    """Moses detokenizer per language locale (cached; the port's own copy
    of sacremoses', ``utils.detokenize``)."""
    if language not in _DETOKENIZERS:
        _DETOKENIZERS[language] = MosesDetokenizer(lang=language)
    return _DETOKENIZERS[language]


def append_gt_preds(
    ids: Sequence[str],
    ref: Sequence[str],
    hyps: Sequence[Sequence[int]],
    target_lang: str,
    tokenizer,
    remove_special_chars: bool = False,
    chars_dict: Optional[Dict[str, int]] = None,
) -> Tuple[List[str], List[str], List[str]]:
    """Detokenize references (text) and hypotheses (token ids) for metrics.

    chars_dict maps surface markers to token ids, e.g. {"[turn]": 7,
    "[xt]": 8} — when removing, the marker is stripped from the reference
    text and the id filtered from the hypothesis (reference ``:401-417``).
    """
    if remove_special_chars and not isinstance(chars_dict, dict):
        raise ValueError("chars_dict must be a dict when removing specials")
    detok = get_detokenizer(target_lang)
    ids_list, ref_list, hyps_list = [], [], []
    for utt_id, target, hyp in zip(ids, ref, hyps):
        if remove_special_chars:
            for key, value in chars_dict.items():
                target = target.replace(key, "").replace("  ", " ")
                hyp = [tok for tok in hyp if tok != value]
        target = detok.detokenize(target.split(" "))
        hyp_text = detok.detokenize(tokenizer.decode_ids(list(hyp)).split(" "))
        ids_list.append(utt_id)
        ref_list.append(target)
        hyps_list.append(hyp_text)
    return ids_list, ref_list, hyps_list


def append_4gt(
    refs: Sequence[Sequence[str]],
    target_lang: str,
    chars_dict: Dict[str, int],
) -> Tuple[List[List[str]], List[List[str]]]:
    """Detokenized 4-reference targets, with and without turn markers
    (reference ``:422-464``; used for fisher dev/dev2/test BLEU)."""
    detok = get_detokenizer(target_lang)
    targets, targets_no_turn = [], []
    for reference in refs:
        targets.append(
            [detok.detokenize(t.split(" ")) for t in reference]
        )
        cleaned = list(reference)
        for key in chars_dict:
            cleaned = [x.replace(key, "").replace("  ", " ") for x in cleaned]
        targets_no_turn.append(
            [detok.detokenize(t.split(" ")) for t in cleaned]
        )
    return targets, targets_no_turn


def _write_csv(path: str, lines: List[List[str]]) -> None:
    lines = [["ID", "gt", "prediction"]] + lines
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="|", quotechar='"',
                            quoting=csv.QUOTE_MINIMAL)
        for line in lines:
            writer.writerow(line)


def print_bleu_or_wer(metrics, filepath: str, logger=None,
                      is_bleu: bool = False) -> None:
    """Write the stats file + `id|gt|prediction` CSV (reference ``:248-287``)."""
    with open(filepath, "w", encoding="utf-8") as w:
        metrics.write_stats(w)
    if is_bleu:
        csv_lines = [
            [i, t, p]
            for i, t, p in zip(metrics.ids, metrics.targets[0],
                               metrics.predicts)
        ]
    else:
        csv_lines = [
            [s["key"], " ".join(s["ref_tokens"]), " ".join(s["hyp_tokens"])]
            for s in metrics.scores
        ]
    _write_csv(filepath.replace(".txt", ".csv"), csv_lines)
    if logger is not None:
        logger.info("%s successfully wrote the models' outputs!", filepath)


def print_inference_output(ids: Sequence[str], ground_truth: str,
                           predictions: Sequence[str], filepath: str) -> None:
    """Per-conversation re-merged outputs with ``[turn]`` joins
    (reference ``:290-363``): utterance ids share a conversation prefix
    before the first '-'; consecutive utterances are joined with [turn]."""
    is_translation = "bleu_" in filepath
    if len(ids) != len(predictions):
        raise ValueError("Nb. IDs does not match Nb. predictions")
    with open(ground_truth) as f:
        gt_data = json.load(f)

    pred_dict: Dict[str, str] = {}
    for utt_id, pred in zip(ids, predictions):
        conv = utt_id.split("-")[0]
        pred_dict[conv] = (
            pred if conv not in pred_dict
            else f"{pred_dict[conv]} [turn] {pred}"
        )
    gt_dict: Dict[str, str] = {}
    for utt_id, value in gt_data.items():
        conv = utt_id.split("-")[0]
        text = value["translation_0"] if is_translation else value["transcription"]
        gt_dict[conv] = (
            text if conv not in gt_dict else f"{gt_dict[conv]} [turn] {text}"
        )

    out_csv = filepath.replace(".txt", ".csv")
    _write_csv(out_csv, [[cid, "", pred] for cid, pred in pred_dict.items()])
    gt_csv = (
        out_csv.replace("-asr.csv", "-gt.csv").replace("-st.csv", "-gt.csv")
    )
    _write_csv(gt_csv, [[cid, tgt, ""] for cid, tgt in gt_dict.items()])
    print(f"{gt_csv} successfully wrote the models' outputs!")
