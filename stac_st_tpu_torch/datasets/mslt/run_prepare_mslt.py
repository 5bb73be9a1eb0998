#!/usr/bin/env python3
"""MSLT preparation driver; a port of ``datasets/mslt/run_prepare_mslt.py``
with the same flags::

    python -m stac_st_tpu_torch.datasets.mslt.run_prepare_mslt \
        --data /path/to/MSLT --out data-mslt --src en --tgt de --subset dev
"""

import argparse
import logging

from ...prep.mslt import prepare_mslt


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--src", required=True)
    parser.add_argument("--tgt", required=True)
    parser.add_argument("--subset", default="dev")
    args = parser.parse_args(argv)
    return prepare_mslt(args.data, args.out, args.src, args.tgt, args.subset)


if __name__ == "__main__":
    main()
