#!/usr/bin/env python3
"""Fisher + CALLHOME Spanish single-turn preparation driver.

Port of ``datasets/fisher_callhome/run_data_preparation.py`` (same flags),
mirroring the reference entry points (``datasets/fisher_callhome/
run_data_preparation.sh`` → ``st_asr_task/data_prep.py``)::

    python -m stac_st_tpu_torch.datasets.fisher_callhome.run_data_preparation \
        --raw /path/to/LDC --out data \
        [--corpus /path/to/fisher-callhome-corpus]

The fisher-callhome-corpus translations must be available locally (the
reference git-clones them at preparation time).
"""

import argparse
import logging

from ...prep.callhome import prepare_callhome
from ...prep.fisher import prepare_fisher


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--raw", required=True, help="LDC root folder")
    parser.add_argument("--out", required=True, help="output data folder")
    parser.add_argument("--corpus", default=None,
                        help="fisher-callhome-corpus checkout")
    args = parser.parse_args(argv)
    prepare_fisher(args.raw, args.out, corpus_path=args.corpus)
    prepare_callhome(args.raw, args.out, corpus_path=args.corpus)


if __name__ == "__main__":
    main()
