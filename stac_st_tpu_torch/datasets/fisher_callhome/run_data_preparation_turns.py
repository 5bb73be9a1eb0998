#!/usr/bin/env python3
"""Fisher + CALLHOME multi-turn preparation + training-mixture merges.

Port of ``datasets/fisher_callhome/run_data_preparation_turns.py`` (same
flags), mirroring ``run_data_preparation_turns.sh`` +
``st_asr_task/data_prep_turns.py``: builds the multi-turn variants (30 s
and 60 s unless ``--max-seconds`` says otherwise) for both corpora, then
merges the JSON manifests into the canonical training mixtures (the
reference's ``jq -s 'add'`` cascade, ``run_data_preparation_turns.sh:
70-113``), e.g. ``fisher-callhome-train-and-30s/data-turns-asr-st.json`` =
single-turn train ∪ 30 s multi-turn train, ASR + ST::

    python -m stac_st_tpu_torch.datasets.fisher_callhome.\
run_data_preparation_turns --raw /path/to/LDC --out data \
        [--corpus /path/to/fisher-callhome-corpus] [--max-seconds 30 60 90]
"""

import argparse
import json
import logging
import os
from typing import Dict, List

from ...prep.callhome import prepare_callhome_turns
from ...prep.fisher import prepare_fisher_turns

logger = logging.getLogger(__name__)


def join_json(json_paths: List[str], out_path: str) -> Dict:
    """Union of manifests + joint transcription/translation field (the
    JAX package's ``prep.mixing.join_json``, whose module is not ported)."""
    merged: Dict[str, Dict] = {}
    for path in json_paths:
        with open(path) as f:
            data = json.load(f)
        for uid, entry in data.items():
            entry = dict(entry)
            if "transcription_and_translation" not in entry:
                entry["transcription_and_translation"] = (
                    f"{entry.get('transcription', '')}\n"
                    f"{entry.get('translation_0', '')}"
                )
            merged[uid] = entry
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(merged, f, indent=2, ensure_ascii=False)
    return merged


def merge(out_folder, name, parts):
    parts = [p for p in parts if os.path.isfile(p)]
    if not parts:
        logger.warning("no inputs for mixture %s", name)
        return
    out_dir = os.path.join(out_folder, name)
    os.makedirs(out_dir, exist_ok=True)
    join_json(parts, os.path.join(out_dir, "data-turns-asr-st.json"))
    logger.info("mixture %s <- %d manifests", name, len(parts))


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--raw", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--corpus", default=None)
    parser.add_argument("--max-seconds", nargs="+", type=float,
                        default=[30.0, 60.0])
    args = parser.parse_args(argv)

    for max_sec in args.max_seconds:
        prepare_fisher_turns(args.raw, args.out, max_sec,
                             corpus_path=args.corpus)
        prepare_callhome_turns(args.raw, args.out, max_sec,
                               corpus_path=args.corpus)

    out = args.out
    # canonical training mixtures (single + multi-turn, ASR + ST)
    merge(out, "fisher-callhome-train-30s", [
        os.path.join(out, "train-30s", "data-turns-asr.json"),
        os.path.join(out, "train-30s", "data-turns-st.json"),
        os.path.join(out, "callhome-train-30s", "data-turns-asr.json"),
        os.path.join(out, "callhome-train-30s", "data-turns-st.json"),
    ])
    merge(out, "fisher-callhome-train-and-30s", [
        os.path.join(out, "train", "data-asr.json"),
        os.path.join(out, "train", "data-st.json"),
        os.path.join(out, "callhome-train", "data-asr.json"),
        os.path.join(out, "callhome-train", "data-st.json"),
        os.path.join(out, "train-30s", "data-turns-asr.json"),
        os.path.join(out, "train-30s", "data-turns-st.json"),
        os.path.join(out, "callhome-train-30s", "data-turns-asr.json"),
        os.path.join(out, "callhome-train-30s", "data-turns-st.json"),
    ])


if __name__ == "__main__":
    main()
