#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s two kernel phases, of this checkout or of
another one, to compare kernel times between trees on one card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/kernel_phases.py [--root OTHER_CHECKOUT]

Imports ``chip_smoke`` and the port from ``--root`` (default: this tree),
builds the kernels, and runs its phases ``kernel`` (the decode kernels
against their plain versions at the serving shapes, with times) and
``train_kernel`` (the flash-attention kernels), each printing its JSON
lines as ``chip_smoke.py`` does, after one line naming the card and the
tree. Call it for parent and change in turns (P, C, C, P) within one
machine session.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from stac_st_tpu_torch.device import set_tf32
    from stac_st_tpu_torch.ops import kernels
    from stac_st_tpu_torch.ops.kernels import decode_attention as K

    set_tf32(False)
    print(json.dumps({"gpu": cs.nvidia_smi(), "root": root,
                      "chip_smoke": cs.__file__}), flush=True)
    kernels.build(["decode_attention", "train_attention"])
    timer = cs.Timer(torch)
    cs.kernel_phase(torch, K, timer)
    cs.train_kernel_phase(torch, kernels, timer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
