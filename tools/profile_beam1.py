#!/usr/bin/env python3
"""Trace one warm beam-1 translate on the card: the decode kernels' device
µs a launch inside the loop.

    python3 tools/profile_beam1.py [--root DIR] [--tag NAME]

The engine is the one chip_smoke.py's main_path builds for its beam-1 call
(flagship width, bf16, seeded random weights, at most 192 tokens, PCM16),
translating the same 2 x 10 s of noise: one call warms the caches, the
next is traced (chip_smoke.profile_beam1). ``--root`` imports
``stac_st_tpu_torch``, and builds its kernels, from another checkout (for
example a parent commit unpacked with ``git archive``), so that two trees
are compared in one run on one card. Prints the card and one JSON
line; the profiler table goes to chiprun_out/profile_beam1_<tag>.txt.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose stac_st_tpu_torch is profiled")
    ap.add_argument("--tag", default="tree", help="names the table file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_beam1: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import stac_st_tpu_torch

    pkg = os.path.dirname(os.path.abspath(stac_st_tpu_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"stac_st_tpu_torch came from {pkg}, not {root}")
    eng1 = smoke.beam1_engine(smoke.flagship(0))
    prof = smoke.profile_beam1(torch, eng1, smoke.serving_wavs()[:2],
                               f"beam1_{args.tag}")
    print(smoke.nvidia_smi(), flush=True)
    smoke.emit({"root": root, "tag": args.tag, **prof})
    return 0


if __name__ == "__main__":
    sys.exit(main())
