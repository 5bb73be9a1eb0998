#!/usr/bin/env python3
"""Time builds of the CTC prefix kernel against each other.

    python3 tools/probe_ctc_prefix.py [--other-source PATH]

Builds ``csrc/ctc_prefix.cu`` several times with the port's nvcc flags and
one of the source's probe settings each: ``STAC_CTC_WARPS`` (candidates,
so warps, a block; the library's default is 4) and ``STAC_CTC_ACCURATE``
(the accurate ``expf``/``log1pf`` in place of the MUFU forms the library
uses). ``--other-source`` adds the build of another tree's
``ctc_prefix.cu`` with the same C entry point (for example the parent's).
Every build is launched through its C entry point at chip_smoke.py's three
cases of the kernel (the flagship joint search, 160 rows x K 11 x T 251 of
V 5000; the full vocabulary at B2 x 5000; T 4,200 at B2 x beam 3, K 4; the
same inputs from the same seeds), held to the plain version (chip_smoke's
CTC_TOL outside the -1e9 class, the class in the same places, bitwise over
two launches) and timed with chip_smoke.py's timer (L2 flushed by writing
256 MB), builds in turns and then in the reverse order. Prints the card,
then one JSON line per case: each build's µs (two rounds), µs a call
among 30 back to back with L2 warm, registers and spilled bytes; the
timer's floor before and after; the µs of one PyTorch indexing call
that gathers the same posterior columns under the same timer; and a
trace: a build with -DSTAC_CTC_TRACE records the global timer at eight
points of each block (CTC_MARK in the source: entry, the staged terms,
the x and the nb maps, nb, b, the stores, the tiles' end, the score), and
one launch after an L2 flush and one after another launch give each
point's median and maximum over the blocks in µs from the first block's
start.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

BUILDS = {
    "w4": [],
    "w4_accurate": ["-DSTAC_CTC_ACCURATE"],
    "w2": ["-DSTAC_CTC_WARPS=2"],
    "w8": ["-DSTAC_CTC_WARPS=8"],
    "w16": ["-DSTAC_CTC_WARPS=16"],
    "w16_accurate": ["-DSTAC_CTC_WARPS=16", "-DSTAC_CTC_ACCURATE"],
}


def build(name: str, src: str, flags):
    """(the loaded library, its ptxas registers and spills) of one build
    of ``src``."""
    from stac_st_tpu_torch.ops import kernels

    out_dir = os.path.join(ROOT, "build", "probe_ctc_prefix")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib_{name}.so")
    done = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags,
                           "-o", so, src], capture_output=True, text=True)
    log = done.stdout + done.stderr
    smoke.check(done.returncode == 0, f"nvcc {name}: {log}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.stac_ctc_prefix_score.argtypes = [P] * 9 + [I] * 7 + [P]
    lib.stac_ctc_prefix_score.restype = I
    regs = smoke.registers(log, "ctc_prefix_kernel")
    spilled = smoke.spills(log, "ctc_prefix_kernel")
    return lib, {"registers": sorted(regs.values()),
                 "spill_bytes": sorted(sum(v) for v in spilled.values())}


def warm_ms(torch, fn, n: int = 30) -> float:
    """Device time of one call among ``n`` back to back, L2 not flushed
    (what the call's inputs leave in the 50 MB L2 stays there)."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def trace(torch, timer, lib, lp, rnb, rb, lst, c, ln, beam, warm):
    """One launch of the trace build (after another launch with ``warm``,
    else after an L2 flush): each CTC_MARK point's median and maximum over
    the blocks, in µs from the first block's start."""
    B, T, V = lp.shape
    rows = rnb.shape[0]
    K = V if c is None else c.shape[1]
    out = [torch.empty((rows, K), device="cuda"),
           torch.empty((rows, K, T), device="cuda"),
           torch.empty((rows, K, T), device="cuda")]
    buf = torch.zeros(1 << 20, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        smoke.check(lib.stac_ctc_prefix_score(
            lp.data_ptr(), rnb.data_ptr(), rb.data_ptr(), lst.data_ptr(),
            None if c is None else c.data_ptr(), ln.data_ptr(),
            *(o.data_ptr() for o in out), rows, K, T, V, beam, 0, 2,
            stream) == 0, "traced launch")

    if warm:
        launch()
    else:
        timer.flush_l2()
    smoke.check(lib.stac_ctc_set_trace(buf.data_ptr()) == 0, "trace on")
    launch()
    torch.cuda.synchronize()
    smoke.check(lib.stac_ctc_set_trace(None) == 0, "trace off")
    t = buf.view(-1, 8)
    t = t[t[:, 0] > 0].double()
    t0 = t[:, 0].min()
    pts = {"blocks": int(t.shape[0])}
    for k in range(8):
        col = t[:, k]
        col = col[col > 0]
        if col.numel():
            us = (col - t0) / 1e3
            pts[k] = [round(float(us.median()), 2), round(float(us.max()), 2)]
    return pts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-source", default=None,
                    help="another tree's csrc/ctc_prefix.cu, built as "
                         "'other'")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_ctc_prefix: no CUDA device", file=sys.stderr)
        return 1
    from stac_st_tpu_torch.ops import kernels
    from stac_st_tpu_torch.ops.kernels import ctc_prefix as KC

    src = str(kernels.CSRC_DIR / "ctc_prefix.cu")
    libs = {name: build(name, src, flags) for name, flags in BUILDS.items()}
    traced, _ = build("trace", src, ["-DSTAC_CTC_TRACE"])
    traced.stac_ctc_set_trace.argtypes = [ctypes.c_void_p]
    traced.stac_ctc_set_trace.restype = ctypes.c_int
    if args.other_source:
        libs["other"] = build("other", args.other_source, [])
    timer = smoke.Timer(torch)
    print(smoke.nvidia_smi(), flush=True)

    g = torch.Generator(device="cpu").manual_seed(13)
    BB = smoke.B * smoke.BEAM
    lp, r_nb, r_b, last, cand, lens = smoke._ctc_inputs(
        torch, g, smoke.B, smoke.BEAM, smoke.S_ENC, smoke.CTC_K,
        lambda g: 126 + torch.randperm(BB, generator=g) * 125 // (BB - 1))
    cases = {"joint": (lp, r_nb, r_b, last, cand, lens, smoke.BEAM),
             "full_vocabulary": (lp[:2].contiguous(), r_nb[:2].contiguous(),
                                 r_b[:2].contiguous(), last[:2].contiguous(),
                                 None, lens[:2].contiguous(), 1)}
    g = torch.Generator(device="cpu").manual_seed(17)
    T = smoke.CTC_LONG_T
    *long_in, long_lens = smoke._ctc_inputs(
        torch, g, 2, 3, T, 4, lambda g: torch.tensor(
            [T - 7, T - 1000, T - 1, T - 333, T - 2047, T - 64]))
    cases["long"] = (*long_in, long_lens, 3)
    stream = torch.cuda.current_stream().cuda_stream

    for key, (lp_, rnb, rb, lst, c, ln, beam) in cases.items():
        B, T, V = lp_.shape
        rows = rnb.shape[0]
        K = V if c is None else c.shape[1]
        want = KC.ctc_prefix_score_ref(lp_, rnb, rb, lst, c, ln, 0, 2, beam)
        rec = {"case": key, "rows": rows, "K": K, "T": T,
               "floor_us": timer.floor_ms() * 1e3}
        outs = {}
        for name, (lib, ptxas) in libs.items():
            if name == "other" and T > 4096:
                continue  # v2's frame cap
            out = [torch.empty((rows, K), device="cuda"),
                   torch.empty((rows, K, T), device="cuda"),
                   torch.empty((rows, K, T), device="cuda")]

            def run(lib=lib, out=out, name=name):
                rc = lib.stac_ctc_prefix_score(
                    lp_.data_ptr(), rnb.data_ptr(), rb.data_ptr(),
                    lst.data_ptr(), None if c is None else c.data_ptr(),
                    ln.data_ptr(), *(o.data_ptr() for o in out), rows, K, T,
                    V, beam, 0, 2, stream)
                smoke.check(rc == 0, f"{name}: launch failed ({rc})")

            run()
            first = [o.clone() for o in out]
            run()
            torch.cuda.synchronize()
            smoke.check(all(torch.equal(a, b) for a, b in zip(first, out)),
                        f"{name} {key}: not bitwise over two launches")
            errs = {}
            for label, x, w in zip(("scores", "r_nb", "r_b"), out, want):
                err, same = smoke._ctc_err(x, w)
                smoke.check(same, f"{name} {key} {label}: -1e9 class")
                smoke.check(err <= smoke.CTC_TOL,
                            f"{name} {key} {label}: relative err {err}")
                errs[label] = err
            outs[name] = run
            rec[name] = {**ptxas, "rel_err": errs, "us": []}
        for order in (list(outs), list(outs)[::-1]):
            for name in order:
                rec[name]["us"].append(timer.ms(outs[name]) * 1e3)
        for name, run in outs.items():
            rec[name]["warm_us"] = warm_ms(torch, run) * 1e3
        # the same posterior columns gathered by one PyTorch indexing call
        # (rows x K x T floats read from (B, T, V) at the candidates),
        # under the same timer: what reading them alone costs
        utt = torch.arange(rows, device="cuda") // beam
        cols = (torch.arange(V, device="cuda").expand(rows, V) if c is None
                else c)
        rec["gather_us"] = timer.ms(
            lambda: lp_[utt[:, None], :, cols]) * 1e3
        rec["floor_us_after"] = timer.floor_ms() * 1e3
        for warm in (False, True):
            rec[f"trace_{'warm' if warm else 'cold'}"] = trace(
                torch, timer, traced, lp_, rnb, rb, lst, c, ln, beam, warm)
        smoke.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
