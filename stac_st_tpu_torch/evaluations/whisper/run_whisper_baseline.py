#!/usr/bin/env python3
"""Whisper baseline driver; a port of
``evaluations/whisper/run_whisper_baseline.py`` with the same flags and
``--device`` (``cuda`` unless ``--device cpu``)::

    python -m stac_st_tpu_torch.evaluations.whisper.run_whisper_baseline \
        --manifest data/dev/data-st.json --model /path/to/whisper-small \
        --task translate --language es [--out results/whisper] --device cuda
"""

import argparse
import logging

from ...eval.whisper_baseline import run_whisper_baseline


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True)
    parser.add_argument("--model", required=True,
                        help="local Whisper checkpoint dir (no download)")
    parser.add_argument("--task", default="transcribe",
                        choices=["transcribe", "translate"])
    parser.add_argument("--language", default="es")
    parser.add_argument("--out", default=None)
    parser.add_argument("--max-utterances", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    summary = run_whisper_baseline(
        args.manifest, args.model, args.task, args.language, args.out,
        args.max_utterances, device=args.device,
    )
    print(summary)
    return summary


if __name__ == "__main__":
    main()
