#!/usr/bin/env python3
"""Long-form segmentation driver (SHAS / WebRTC pipeline).

Port of ``datasets/fisher_callhome/run_segmentation.py`` (same flags).
Mirrors ``run_shas_segmentation.sh`` end to end over a prepared subset
folder containing ``data.json`` (ground-truth manifest) and ``wavs/``
(full-conversation 16 kHz mono wavs named ``<recording>.wav``):

1. mask un-annotated audio to zero (``mask_wav_files.py``),
2. segment every masked wav with either the WebRTC pause-based collector
   (frame 10 ms, aggressiveness 1 — ``run_shas_segmentation.sh:113-121``)
   or the SHAS pDAC over the min/max grid (``:217-224``),
3. write the SHAS-format segmentation YAML, and
4. cut per-segment wavs + emit ``data-resegmented-{asr,st}.json``
   (``create_json_and_segment.py``).

    # pause-based (webrct analogue)
    python -m stac_st_tpu_torch.datasets.fisher_callhome.run_segmentation \
        --base data/dev-webrct --method pause

    # SHAS DAC at one grid point
    python -m stac_st_tpu_torch.datasets.fisher_callhome.run_segmentation \
        --base data/dev-10-to-15 --method shas --min 10 --max 15
"""

import argparse
import glob
import logging
import os

from ...prep.shas import (
    create_json_and_segment,
    mask_wav_files,
    pause_based_segmentation,
    shas_segmentation,
    write_segmentation_yaml,
)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--base", required=True,
                        help="subset folder with data.json + wavs/")
    parser.add_argument("--method", choices=["pause", "shas"],
                        default="shas")
    parser.add_argument("--min", type=float, default=10.0,
                        help="DAC min segment length (s)")
    parser.add_argument("--max", type=float, default=30.0,
                        help="DAC max segment length (s)")
    parser.add_argument("--frame-ms", type=int, default=10)
    parser.add_argument("--aggressiveness", type=int, default=1)
    parser.add_argument("--skip-mask", action="store_true",
                        help="segment the raw wavs (no GT masking)")
    args = parser.parse_args(argv)

    base = args.base
    wav_dir = os.path.join(base, "wavs")
    masked_dir = os.path.join(base, "masked_wavs")
    reseg_dir = os.path.join(base, "resegmented")
    gt_json = os.path.join(base, "data.json")

    if args.skip_mask:
        masked_dir = wav_dir
    elif not os.path.isfile(os.path.join(masked_dir, ".done")):
        logging.info("masking wavs with ground-truth segmentation")
        mask_wav_files(gt_json, wav_dir, masked_dir)
        open(os.path.join(masked_dir, ".done"), "w").close()

    yaml_name = (
        "webrct_output.yaml" if args.method == "pause"
        else "shas_output.yaml"
    )
    yaml_path = os.path.join(base, yaml_name)
    segments = []
    for wav in sorted(glob.glob(os.path.join(masked_dir, "*.wav"))):
        if args.method == "pause":
            segs = pause_based_segmentation(
                wav, frame_ms=args.frame_ms,
                aggressiveness=args.aggressiveness,
            )
        else:
            segs = shas_segmentation(wav, args.min, args.max)
        logging.info("%s: %d segments", os.path.basename(wav), len(segs))
        segments.extend(segs)
    write_segmentation_yaml(segments, yaml_path)

    asr_json, st_json = create_json_and_segment(
        yaml_path, base, masked_dir, reseg_dir
    )
    logging.info("wrote %s and %s", asr_json, st_json)


if __name__ == "__main__":
    main()
