#!/usr/bin/env python3
"""Time self_split_kernel over a grid of launch shapes on the card.

    python3 tools/probe_self_split.py

The self kernel of stac_st_tpu_torch/csrc/decode_attention.cu runs a
cluster of ``cs`` blocks of ``warps`` (at most 4) warps per (row, head);
the library picks the shape from the positions read (``self_shape``). This builds the
same source with one more entry point that takes the shape, and times every
shape of a small grid, bf16, at the shapes of the main path: 160 rows (the
kernel phase's continuity case), 16 rows (B16 greedy) at idx 194 of S 195
and idx 97 of S 131, and 2 rows (the smoke's beam-1 call). Each launch is
held to the plain version (1e-2) and to itself over two launches (bitwise).

Two timers: chip_smoke.py's (L2 flushed by writing 256 MB, which leaves
the cache full of dirty lines that a kernel's reads must write back) and
the same with a read-only flush (clean lines). Beside each case, one
torch.sum over as many bf16 bytes as the case's K and V: the card's own
time to read those bytes under each timer. Prints the card and one JSON
line per case.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

SHAPES = ((160, 195, 194), (16, 195, 194), (16, 131, 97), (2, 195, 194))
GRID = ((1, 1), (1, 2), (1, 4), (2, 2), (2, 4), (4, 1), (4, 2), (7, 1))
ENTRY = """#include "{src}"
extern "C" int probe_self_split(const void* q, const void* kT, const void* v,
                                void* out, int BB, int H, int S, int idx, int cs,
                                int warps, void* stream) {{
  return launch_self_split<__nv_bfloat16>(q, kT, v, out, BB, H, S, idx,
                                          SelfShape{{cs, warps}},
                                          (cudaStream_t)stream);
}}
"""


def build():
    from stac_st_tpu_torch.ops import kernels

    out_dir = os.path.join(ROOT, "build", "probe_self_split")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(ENTRY.format(src=kernels.CSRC_DIR / "decode_attention.cu"))
    so = os.path.join(out_dir, "probe.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_self_split.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.probe_self_split.restype = I
    return lib


class CleanTimer(smoke.Timer):
    """chip_smoke's timer with a read-only flush: L2 holds clean lines."""

    def __init__(self, torch):
        super().__init__(torch)
        self.flush.normal_()
        self.sink = torch.empty((), device="cuda")

    def flush_l2(self) -> None:
        self.torch.sum(self.flush, dim=0, out=self.sink)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_self_split: no CUDA device", file=sys.stderr)
        return 1
    from stac_st_tpu_torch.ops.kernels import decode_attention as K

    lib = build()
    timers = {"dirty": smoke.Timer(torch), "clean": CleanTimer(torch)}
    g = torch.Generator().manual_seed(0)
    H, DH = smoke.H, smoke.DH
    print(smoke.nvidia_smi(), flush=True)
    for rows, S, idx in SHAPES:
        bf = torch.bfloat16
        q = (torch.randn(rows, H, DH, generator=g) / 8).to("cuda", bf)
        kT = torch.randn(rows, H, DH, S, generator=g).to("cuda", bf)
        v = torch.randn(rows, H, S, DH, generator=g).to("cuda", bf)
        ref = K.decode_self_attention_ref(q, kT, v, idx)
        tiles = (idx + 32) // 32
        block = torch.empty(2 * rows * H * (idx + 1) * DH, dtype=bf,
                            device="cuda")
        rec = {"rows": rows, "S": S, "idx": idx, "tiles": tiles,
               "bound_us": smoke.bound_ms(
                   (2 * rows * H * DH + 2 * rows * H * (idx + 1) * DH) * 2,
                   4.0 * rows * H * (idx + 1) * DH, "bfloat16")[0] * 1e3}
        for name, timer in timers.items():
            rec[f"floor_us_{name}"] = timer.floor_ms() * 1e3
            rec[f"read_kv_bytes_us_{name}"] = timer.ms(
                lambda: torch.sum(block)) * 1e3
        for cs, warps in GRID:
            if cs > tiles:
                continue
            out = torch.empty_like(q)

            def run():
                rc = lib.probe_self_split(
                    q.data_ptr(), kT.data_ptr(), v.data_ptr(),
                    out.data_ptr(), rows, H, S, idx, cs, warps,
                    torch.cuda.current_stream().cuda_stream)
                smoke.check(rc == 0, f"probe launch cs {cs} warps {warps}")

            run()
            first = out.clone()
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            smoke.check(err <= 1e-2, f"cs {cs} warps {warps}: err {err}")
            smoke.check(torch.equal(first, out), "not repeatable")
            rec[f"cs{cs}_w{warps}"] = {name: timer.ms(run) * 1e3
                                       for name, timer in timers.items()}
        smoke.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
