#!/usr/bin/env python3
"""CoVoST2 preparation driver; a port of
``datasets/covost2/run_prepare_covost2.py`` with the same flags::

    python -m stac_st_tpu_torch.datasets.covost2.run_prepare_covost2 \
        --tsv covost_v2.es_en.tsv --cv data-cv/es/all.json \
        --out data-covost --src es --tgt en
"""

import argparse
import logging

from ...prep.covost import prepare_covost


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--tsv", required=True)
    parser.add_argument("--cv", required=True,
                        help="prepared CommonVoice manifest (all.json)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--src", required=True)
    parser.add_argument("--tgt", required=True)
    args = parser.parse_args(argv)
    return prepare_covost(args.tsv, args.cv, args.out, args.src, args.tgt)


if __name__ == "__main__":
    main()
