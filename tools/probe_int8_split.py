#!/usr/bin/env python3
"""Time the int8 cache's split kernels over a grid of launch shapes.

    python3 tools/probe_int8_split.py

decode_self_attention_int8 and decode_cross_attention_int8 run a cluster
of ``cs`` blocks of ``warps`` warps (at most 8, cross 4) per (row, head) -- per
(utterance, head) for cross -- over 32-position tiles; the library picks
the shape from the tiles (``i8::split_shape``, ``i8::cross_shape``). This
builds the same
source with entry points that take the shape, and times every shape of a
small grid, bf16, with chip_smoke.py's timer (L2 flushed by writing
256 MB), at the main path's shapes: self at 160 rows x 195 (idx 194, beam
10 in gather mode) and 16 rows idx 194 (B16 greedy), the ragged form at
the slot loop's 16 slots, cross at B16 x beam 10 x 251 and at the slot
loop's 16 x 801 with the per-slot bias (and, to price the bias, with no
bias and with one that masks nothing). Each launch is held to the plain
version (1e-2) and to itself over two launches (bitwise). Prints the card
and one JSON line per case, with the library's own shape marked.

A second build (-DSTAC_I8_TRACE) records the global timer at eight points
of each block (I8_MARK in the source); one launch a shape, after the same
flush, gives each point's median and maximum over the blocks, in µs from
the first block's start (``trace``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

GRID = ((1, 4), (1, 7), (1, 8), (2, 2), (2, 4), (4, 2), (4, 4), (7, 1),
        (8, 1), (8, 2), (8, 4))
ENTRY = """#include "{src}"
extern "C" int probe_self(const void* q, const void* kT, const void* v,
                          const void* ks, const void* vs, void* out, int BB,
                          int H, int S, int idx, int cs, int warps,
                          void* stream) {{
  return i8::launch_self_split<__nv_bfloat16>(q, kT, v, ks, vs, out, BB, H,
                                              S, idx, i8::Shape{{cs, warps}},
                                              (cudaStream_t)stream);
}}
extern "C" int probe_rows(const void* q, const void* kT, const void* v,
                          const void* ks, const void* vs, const void* rows,
                          void* out, int BB, int H, int S, int cs, int warps,
                          void* stream) {{
  return i8::launch_self_split_rows<__nv_bfloat16>(
      q, kT, v, ks, vs, rows, out, BB, H, S, i8::Shape{{cs, warps}},
      (cudaStream_t)stream);
}}
extern "C" int probe_cross(const void* q, const void* kT, const void* v,
                           const void* ks, const void* vs, const void* bias,
                           void* out, int B, int H, int S, int beam, int cs,
                           int warps, void* stream) {{
  return i8::launch_cross_split<__nv_bfloat16>(
      q, kT, v, ks, vs, bias, out, B, H, S, beam, i8::Shape{{cs, warps}},
      (cudaStream_t)stream);
}}
extern "C" int probe_set_trace(void* p) {{
#ifdef STAC_I8_TRACE
  return (int)cudaMemcpyToSymbol(i8::i8_trace, &p, sizeof(p));
#else
  return 0;
#endif
}}
extern "C" int probe_shape(int tiles, int heads, int self) {{
  const i8::Shape sh = self ? i8::split_shape(tiles, heads, i8::SELF_WARPS)
                            : i8::cross_shape(tiles, heads);
  return sh.cs * 8 + sh.warps;
}}
"""


def build(trace: bool = False):
    from stac_st_tpu_torch.ops import kernels

    out_dir = os.path.join(ROOT, "build", "probe_int8_split")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(ENTRY.format(src=kernels.CSRC_DIR / "decode_attention.cu"))
    so = os.path.join(out_dir, f"probe{'_trace' if trace else ''}.so")
    flags = ["-DSTAC_I8_TRACE"] if trace else []
    done = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags,
                           "-o", so, src], capture_output=True, text=True)
    smoke.check(done.returncode == 0, f"nvcc: {done.stdout}{done.stderr}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_self.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.probe_rows.argtypes = [P] * 7 + [I] * 5 + [P]
    lib.probe_cross.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.probe_shape.argtypes = [I, I, I]
    lib.probe_set_trace.argtypes = [P]
    for fn in (lib.probe_self, lib.probe_rows, lib.probe_cross,
               lib.probe_shape, lib.probe_set_trace):
        fn.restype = I
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_int8_split: no CUDA device", file=sys.stderr)
        return 1
    from stac_st_tpu_torch.models.transformer import quantize_rows
    from stac_st_tpu_torch.ops.kernels import decode_attention as K

    lib, traced = build(), build(trace=True)
    timer = smoke.Timer(torch)
    g = torch.Generator().manual_seed(0)
    H, DH, bf = smoke.H, smoke.DH, torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    print(smoke.nvidia_smi(), flush=True)

    def cache(rows, S):
        kT, ks = quantize_rows(torch.randn(rows, H, DH, S, generator=g)
                               .cuda(), 2)
        v, vs = quantize_rows(torch.randn(rows, H, S, DH, generator=g)
                              .cuda(), 3)
        return kT, v, ks, vs.transpose(2, 3).contiguous()

    def probe(rec, tiles, heads, call, ref, streams=()):
        # the card's own time to read the case's int8 K and V (a sum of
        # their bytes taken as fp32)
        for i, t in enumerate(streams):
            rec[f"read_us_{i}"] = timer.ms(lambda t=t: torch.sum(t)) * 1e3
        lib_shape = lib.probe_shape(tiles, heads, int("self" in rec["case"]))
        grid = GRID if "self" in rec["case"] else [x for x in GRID if x[1] <= 4]
        rec["library_shape"] = f"cs{lib_shape // 8}_w{lib_shape % 8}"
        rec["floor_us"] = timer.floor_ms() * 1e3
        for cs, warps in grid:
            if cs > tiles:
                continue
            out = torch.empty_like(ref)

            def run():
                rc = call(out, cs, warps)
                smoke.check(rc == 0, f"probe launch cs {cs} warps {warps}")

            run()
            first = out.clone()
            run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            smoke.check(err <= 1e-2, f"cs {cs} warps {warps}: err {err}")
            smoke.check(torch.equal(first, out), "not repeatable")
            rec[f"cs{cs}_w{warps}"] = timer.ms(run) * 1e3
            rec.setdefault("trace", {})[f"cs{cs}_w{warps}"] = trace_of(
                call, out, cs, warps)
        smoke.emit(rec)

    def trace_of(call, out, cs, warps):
        buf = torch.zeros(1 << 20, dtype=torch.int64, device="cuda")
        smoke.check(traced.probe_set_trace(buf.data_ptr()) == 0, "trace")
        timer.flush_l2()
        smoke.check(call(out, cs, warps, traced) == 0, "traced launch")
        torch.cuda.synchronize()
        smoke.check(traced.probe_set_trace(None) == 0, "trace off")
        t = buf.view(-1, 8)
        t = t[t[:, 0] > 0].double()
        t0 = t[:, 0].min()
        pts = {}
        for k in range(8):
            col = t[:, k]
            col = col[col > 0]
            if col.numel():
                us = (col - t0) / 1e3
                pts[k] = [round(float(us.median()), 2),
                          round(float(us.max()), 2)]
        return pts

    S = smoke.S_SELF
    for rows in (160, 16):
        idx = S - 1
        kT, v, ks, vs = cache(rows, S)
        q = torch.randn(rows, H, DH, generator=g).to("cuda", bf)
        ptrs = [t.data_ptr() for t in (q, kT, v, ks, vs)]
        probe({"case": "self", "rows": rows, "S": S, "idx": idx},
              (idx + 32) // 32, rows * H,
              lambda out, cs, w, lb=lib, ptrs=ptrs, rows=rows, idx=idx:
              lb.probe_self(*ptrs, out.data_ptr(), rows, H, S, idx, cs, w,
                            stream),
              K.decode_self_attention_int8_ref(q, kT, v, ks, vs, idx),
              (torch.cat([kT.view(-1), v.view(-1)]).view(torch.float32),))
    R = len(smoke.ROWS_IDX)
    kT, v, ks, vs = cache(R, S)
    q = torch.randn(R, H, DH, generator=g).to("cuda", bf)
    idx = torch.tensor(smoke.ROWS_IDX, dtype=torch.int32, device="cuda")
    ptrs = [t.data_ptr() for t in (q, kT, v, ks, vs, idx)]
    probe({"case": "ragged self", "rows": R, "S": S},
          (S + 31) // 32, R * H,
          lambda out, cs, w, lb=lib: lb.probe_rows(*ptrs, out.data_ptr(), R,
                                                   H, S, cs, w, stream),
          K.decode_self_attention_int8_ref(q, kT, v, ks, vs, idx))
    bias, _ = smoke._slot_bias(torch)
    for rows, S, beam, b in ((smoke.B, smoke.S_ENC, smoke.BEAM, None),
                             (R, smoke.S_MAX, 1, bias),
                             (R, smoke.S_MAX, 1, None),
                             (R, smoke.S_MAX, 1, torch.zeros_like(bias))):
        kT, v, ks, vs = cache(rows, S)
        q = torch.randn(rows * beam, H, DH, generator=g).to("cuda", bf)
        ptrs = [t.data_ptr() for t in (q, kT, v, ks, vs)]
        bp = None if b is None else b.data_ptr()
        probe({"case": "cross", "utterances": rows, "beam": beam, "S": S,
               "bias": None if b is None else
               "slot loop" if b is bias else "none masked"},
              (S + 31) // 32, rows * H,
              lambda out, cs, w, lb=lib, ptrs=ptrs, bp=bp, rows=rows, S=S,
              beam=beam: lb.probe_cross(*ptrs, bp, out.data_ptr(), rows, H, S,
                                        beam, cs, w, stream),
              K.decode_cross_attention_int8_ref(q, kT, v, ks, vs, b, beam))
    return 0


if __name__ == "__main__":
    sys.exit(main())
