#!/usr/bin/env python3
"""Cross-dataset experiment trees; a port of
``datasets/cross_datasets_experiments/prepare_cross_datasets.py`` with the
same flags.

Builds per-language-pair mixtures ``<src>_to_<src>.and.<tgt>`` by joining
CV ASR manifests with CoVoST ST manifests, plus synthetic multi-turn
variants via random concatenation::

    python -m stac_st_tpu_torch.datasets.cross_datasets_experiments.\
prepare_cross_datasets --cv data-cv --covost data-covost --out data-cross \
        --pairs es_en en_de de_en fr_en [--multi-turn-seconds 30]
"""

import argparse
import logging
import os

from ...prep.mixing import concat_json, join_json

logger = logging.getLogger(__name__)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--cv", required=True)
    parser.add_argument("--covost", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--pairs", nargs="+", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--multi-turn-seconds", type=float, default=0.0)
    args = parser.parse_args(argv)

    all_manifests = []
    for pair in args.pairs:
        src, tgt = pair.split("_")
        cv_json = os.path.join(args.cv, src, f"{args.split}.json")
        st_json = os.path.join(args.covost, f"covost_{src}_{tgt}",
                               f"{args.split}.json")
        parts = [p for p in (cv_json, st_json) if os.path.isfile(p)]
        if not parts:
            logger.warning("no manifests for pair %s", pair)
            continue
        tree = os.path.join(args.out, f"{src}_to_{src}.and.{tgt}")
        os.makedirs(tree, exist_ok=True)
        out_json = os.path.join(tree, "data-asr-st.json")
        join_json(parts, out_json)
        all_manifests.append(out_json)
        if args.multi_turn_seconds > 0:
            concat_json(
                out_json,
                os.path.join(tree, "data-turns-asr-st.json"),
                max_seconds=args.multi_turn_seconds,
            )
        logger.info("pair %s -> %s", pair, tree)

    if len(all_manifests) > 1:  # the ALL<->ALL mix
        tree = os.path.join(args.out, "all_to_all")
        os.makedirs(tree, exist_ok=True)
        join_json(all_manifests, os.path.join(tree, "data-asr-st.json"))
    return all_manifests


if __name__ == "__main__":
    main()
