#!/usr/bin/env python3
"""Compare the compiled decode and training kernels of two checkouts.

Run from the repository root on a machine with the CUDA toolkit:

    python3 tools/compare_sass.py --root OTHER_CHECKOUT

Builds ``csrc/decode_attention.cu`` and ``csrc/train_attention.cu`` of both
trees with the port's own build rule (``stac_st_tpu_torch.ops.kernels``,
nvcc for sm_90a), dumps each library's SASS with ``cuobjdump -sass``,
strips the instruction addresses and encodings, and prints one JSON line:
for every kernel function the two libraries share, whether its SASS is
identical, plus the functions found in one tree only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBS = ("decode_attention", "train_attention")


def build(root: str):
    """The kernels module of the checkout at ``root``, its libraries
    built (a fresh import of the package from that tree)."""
    for name in [m for m in sys.modules if m.startswith("stac_st_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        kernels = importlib.import_module("stac_st_tpu_torch.ops.kernels")
        kernels.build(LIBS)
        return {n: str(kernels._target(n)) for n in LIBS}
    finally:
        sys.path.remove(root)


# nvcc names a file's anonymous namespace after the file and a hash
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")


def functions(lib: str):
    """{kernel function: its SASS without addresses or encodings}, the
    anonymous namespace's name made the same in every tree."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines():
        line = _ANON.sub("_GLOBAL__N_", line)
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(body)
            name, body = m.group(1), []
            continue
        if name is None:
            continue
        line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)  # address
        line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line)  # encoding
        line = line.strip()
        if line:
            body.append(line)
    if name:
        out[name] = "\n".join(body)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the other checkout")
    args = ap.parse_args()
    other = os.path.abspath(args.root)
    libs = {"this": build(ROOT), "other": build(other)}
    result = {}
    for n in LIBS:
        mine, theirs = (functions(libs[k][n]) for k in ("this", "other"))
        shared = sorted(set(mine) & set(theirs))
        result[n] = {
            "identical": [f for f in shared if mine[f] == theirs[f]],
            "different": [f for f in shared if mine[f] != theirs[f]],
            "only_this": sorted(set(mine) - set(theirs)),
            "only_other": sorted(set(theirs) - set(mine))}
    print(json.dumps({"sass": result}), flush=True)
    return 0 if not any(r["different"] for r in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
