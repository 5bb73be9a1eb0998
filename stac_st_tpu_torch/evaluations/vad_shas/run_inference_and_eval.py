#!/usr/bin/env python3
"""Long-form VAD inference + realignment + scoring pipeline (port of
``evaluations/vad_shas/run_inference_and_eval.py``: the same printed
scores).

Re-owns ``evaluations/vad_shas/{run_inference.sh,run_align_and_eval.sh}``:
decode VAD-resegmented conversations with the inference recipe, re-merge the
hypothesis stream per conversation, realign it to the multi-turn reference
segmentation (built-in minimum-WER segmentation replaces the external
mwerSegmenter), and report BLEU/WER plus speaker-change F1 over the
tolerance grid.

    python -m stac_st_tpu_torch.evaluations.vad_shas.run_inference_and_eval \
        --hyp-csv results/inference/bleu_conv_10_30-st.csv \
        --ref-manifest data/dev-30s/data-turns-st.json \
        [--rttm results/inference/RTTM_conv_10_30_turn.csv]
"""

import argparse
import csv
import json

from ...eval.long_form import realign_hypotheses
from ...eval.speaker_change import (
    TOLERANCE_GRID,
    evaluate_speaker_change,
    gt_changes_from_manifest,
    hyp_changes_from_rttm,
)
from ...utils.metrics import BLEUStats, ErrorRateStats


def read_hyp_csv(path):
    """id|gt|prediction CSVs from the inference recipe (per conversation)."""
    out = {}
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="|")
        header = next(reader, None)
        for row in reader:
            if len(row) >= 3:
                out[row[0]] = row[2]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hyp-csv", required=True)
    parser.add_argument("--ref-manifest", required=True)
    parser.add_argument("--rttm", default=None)
    parser.add_argument("--metric", default="bleu", choices=["bleu", "wer"])
    args = parser.parse_args(argv)

    with open(args.ref_manifest) as f:
        ref_data = json.load(f)
    hyp_by_conv = read_hyp_csv(args.hyp_csv)

    # group reference utterances per conversation, in uid order
    ref_by_conv = {}
    for uid in sorted(ref_data):
        conv = uid.split("-")[0]
        field = (
            "translation_0" if args.metric == "bleu" else "transcription"
        )
        text = ref_data[uid].get(field, "")
        text = text.replace("[turn]", " ").replace("[xt]", " ")
        ref_by_conv.setdefault(conv, []).append(" ".join(text.split()))

    bleu = BLEUStats()
    wer = ErrorRateStats()
    for conv, refs in ref_by_conv.items():
        stream = hyp_by_conv.get(conv, "")
        stream = stream.replace("[turn]", " ").replace("[xt]", " ")
        stream = " ".join(stream.split())
        realigned = realign_hypotheses(refs, stream)
        ids = [f"{conv}-{i}" for i in range(len(refs))]
        if args.metric == "bleu":
            bleu.append(ids, realigned, [refs])
        else:
            wer.append(ids, [h.split() for h in realigned],
                       [r.split() for r in refs])

    if args.metric == "bleu":
        print(f"BLEU (realigned): {bleu.summarize('BLEU'):.2f}")
    else:
        print(f"WER (realigned): {wer.summarize('error_rate'):.2f}")

    if args.rttm:
        gt = gt_changes_from_manifest(args.ref_manifest)
        hyp = hyp_changes_from_rttm(args.rttm)
        for m in evaluate_speaker_change(gt, hyp, TOLERANCE_GRID):
            d = m.as_dict()
            print(
                f"tol={d['tolerance']:.2f}s P={d['precision']:.3f} "
                f"R={d['recall']:.3f} F1={d['f1']:.3f}"
            )


if __name__ == "__main__":
    main()
