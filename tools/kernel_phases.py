#!/usr/bin/env python3
"""Run only ``chip_smoke.py``'s kernel phases, of this checkout or of
another one, to compare kernel times between trees on one card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/kernel_phases.py [--root OTHER_CHECKOUT]
        [--phases kernel,train_kernel,ctc,joint_ctc]

Imports ``chip_smoke`` and the port from ``--root`` (default: this tree),
builds the kernels, and runs the named phases (default ``kernel`` and
``train_kernel``), each printing its JSON lines as ``chip_smoke.py`` does,
after one line naming the card and the tree: ``kernel`` (the decode
kernels against their plain versions at the serving shapes, with times),
``train_kernel`` (the flash-attention kernels), ``ctc`` (the CTC prefix
kernel's cases of phase ``search_options``) and ``joint_ctc`` (the joint
CTC/attention searches of phase ``search_options``, the float one traced
with torch.profiler: the CTC kernel's device µs a launch and share of the
device's busy time). Call it for parent and change in turns (P, C, C, P)
within one machine session.
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
    ap.add_argument("--phases", default="kernel,train_kernel",
                    help="comma-separated: kernel, train_kernel, ctc, "
                         "joint_ctc")
    args = ap.parse_args()
    phases = args.phases.split(",")
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
    kernels.build(["decode_attention", "train_attention"]
                  + (["ctc_prefix"] if {"ctc", "joint_ctc"} & set(phases)
                     else []))
    timer = cs.Timer(torch)
    if "kernel" in phases:
        cs.kernel_phase(torch, K, timer)
    if "train_kernel" in phases:
        cs.train_kernel_phase(torch, kernels, timer)
    if "ctc" in phases:
        cs.ctc_kernel_cases(torch, kernels, timer)
    if "joint_ctc" in phases:
        wavs = cs.serving_wavs()
        eng = cs.options_engine(cs.flagship(0))
        eng.translate(wavs)
        base, att_wall = cs._timed(torch, lambda: eng.translate(wavs))
        del eng
        joint = cs.joint_ctc_cases(torch, kernels, wavs, base, att_wall,
                                   True)
        cs.emit({"phase": "joint_ctc", **joint})
    return 0


if __name__ == "__main__":
    sys.exit(main())
