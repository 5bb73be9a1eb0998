#!/usr/bin/env python3
"""pyannote baseline driver; a port of
``evaluations/pyannote/run_pyannote_baseline.py`` with the same flags and
``--device`` (``cuda`` unless ``--device cpu``).

Runs pyannote segmentation/diarization over conversation wavs and writes
one RTTM a wav. The default backend requires pyannote.audio + an HF
checkpoint; ``--backend local`` runs the same model path on the port's
first-party PyanNet-architecture checkpoint, built on the device with
``--build-local``::

    python -m stac_st_tpu_torch.evaluations.pyannote.run_pyannote_baseline \
        --wavs conv*.wav --backend local --build-local --out results/pyannote \
        --device cuda
"""

import argparse
import logging
import os

from ...eval.pyannote_baseline import run_pyannote_baseline


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--wavs", nargs="+", required=True)
    parser.add_argument("--mode", default="segmentation",
                        choices=["segmentation", "diarization"])
    parser.add_argument("--model", default=None)
    parser.add_argument("--token", default=None)
    parser.add_argument("--out", default="results/pyannote")
    parser.add_argument("--backend", default="pyannote",
                        choices=["pyannote", "local"],
                        help="'local' = first-party PyanNet backend "
                        "(both modes; diarization clusters local-speaker "
                        "embeddings; --model is a local checkpoint path)")
    parser.add_argument("--build-local", action="store_true",
                        help="build the miniature local segmentation "
                        "checkpoint at --model (or <out>/local_seg.pt) "
                        "before running")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.build_local:
        from ...eval.pyannote_local import (
            build_local_segmentation_checkpoint,
        )

        os.makedirs(args.out, exist_ok=True)
        args.model = args.model or os.path.join(args.out, "local_seg.pt")
        build_local_segmentation_checkpoint(args.model, device=args.device)
        args.backend = "local"
    results = run_pyannote_baseline(args.wavs, args.mode, args.model,
                                    args.token, backend=args.backend,
                                    device=args.device)
    os.makedirs(args.out, exist_ok=True)
    for wav, lines in results.items():
        name = os.path.splitext(os.path.basename(wav))[0]
        with open(os.path.join(args.out, f"{name}.rttm"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return results


if __name__ == "__main__":
    main()
