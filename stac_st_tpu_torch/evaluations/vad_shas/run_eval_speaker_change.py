#!/usr/bin/env python3
"""Speaker-change evaluation over the tolerance grid.

Port of ``evaluations/vad_shas/run_eval_speaker_change.py`` (same modes,
same printed lines and report), mirroring the reference's
``eval_speaker_change.sh`` + ``get_f1_score.py``.

Reference-exact mode (the shell script's path — fixed ref/hyp RTTM pair,
region-merge semantics, oracle-tested vs the reference scorer):

    python -m stac_st_tpu_torch.evaluations.vad_shas.run_eval_speaker_change \
        --ref-rttm out/RTTM_dev_turn.ref.rttm \
        --rttm out/RTTM_dev_turn.hyp.rttm [--out report.json]

Manifest mode (score CTC-spike events straight off the multi-turn manifest,
greedy point matching — no RTTM fixing needed):

    python -m stac_st_tpu_torch.evaluations.vad_shas.run_eval_speaker_change \
        --manifest data/dev-30s/data-turns-st.json \
        --rttm results/.../RTTM_dev-30s_turn.csv [--out report.json]
"""

import argparse
import json

from ...eval.speaker_change import (
    TOLERANCE_GRID,
    evaluate_speaker_change,
    evaluate_speaker_turn_detection,
    gt_changes_from_manifest,
    hyp_changes_from_rttm,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", default=None,
                        help="multi-turn manifest (point-matching mode)")
    parser.add_argument("--ref-rttm", default=None,
                        help="reference RTTM (reference-exact region mode)")
    parser.add_argument("--rttm", required=True, help="hypothesis RTTM")
    parser.add_argument("--out", default=None)
    parser.add_argument("--no-merge-gt", action="store_true",
                        help="disable GT region merging (region mode)")
    parser.add_argument("--mean-turn-point", action="store_true",
                        help="score the region midpoint (region mode)")
    parser.add_argument("--tolerances", nargs="+", type=float,
                        default=list(TOLERANCE_GRID))
    args = parser.parse_args(argv)
    if (args.manifest is None) == (args.ref_rttm is None):
        parser.error("pass exactly one of --manifest / --ref-rttm")

    if args.ref_rttm is not None:
        results = evaluate_speaker_turn_detection(
            args.ref_rttm, args.rttm, args.tolerances,
            merge_overlap_gt_regions=not args.no_merge_gt,
            mean_turn_point=args.mean_turn_point,
        )
        for m in results:
            print(
                f"{m['tolerance']}s: {m['precision']:.2f} {m['recall']:.2f} "
                f"{m['f1']:.2f} {m['miss']:.2f} {m['fa']:.2f}"
            )
    else:
        ref = gt_changes_from_manifest(args.manifest)
        hyp = hyp_changes_from_rttm(args.rttm)
        results = [m.as_dict() for m in
                   evaluate_speaker_change(ref, hyp, args.tolerances)]
        for m in results:
            print(
                f"tol={m['tolerance']:.2f}s  P={m['precision']:.3f} "
                f"R={m['recall']:.3f} F1={m['f1']:.3f} "
                f"MDR={m['MDR']:.3f} FAR={m['FAR']:.3f}"
            )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
