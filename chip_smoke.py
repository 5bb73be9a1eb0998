#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stac_st_tpu_torch) on one GPU, end to end.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py             # the check
    python3 chip_smoke.py --profile   # also trace one warm translate call
                                      # and warm train steps

Phases, each printed as one JSON line:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions, and the build time of the kernels (nvcc, sm_90a, every
   source of stac_st_tpu_torch/csrc built in parallel into
   build/torch_kernels/); ptxas must report no spills for the
   tensor-core kernels (fwd_tc_kernel, four instantiations; dq_tc_kernel
   and dkv_tc_kernel, two each) and for the split decode kernels
   (self_split_kernel, cross_split_kernel and anc_split_kernel, two
   each), whose registers are reported;
2. kernel: each decode-attention kernel against its plain PyTorch version
   at the serving path's shapes (B 16 x 10 s, beam 10: 160 rows, 4 heads of
   64, self cache 3 + 192 positions, 251 encoder frames), in fp32 with TF32
   off and in bf16, with the times of the kernel, the plain version, one
   library call computing the same function (timed here only; the port
   never calls it: scaled_dot_product_attention on K and V laid out
   contiguous, built outside the timed call, the fastest of its fused
   backends that accepts the call, named), the least time the card could
   take, the wrapper's host time a call, and the timer's floor (one tiny
   kernel); cross also with a padding bias that masks whole position
   splits and one whole row; all three in bf16 go through their "split"
   kernels (ptxas must report no spills for them), which must give
   bitwise-equal outputs over two launches and are also timed at the
   other shapes of the main path (self at B16 greedy decoding, 16 rows,
   idx 194 of the 195-position cache segment and idx 97 of the
   131-position one; anc mid-decode, idx 97 of 131; cross at the dual
   search's B32);
3. train_kernel: the four flash-attention kernels (inference forward,
   training forward, dQ, dK/dV) against their plain versions at the
   training path's shapes (encoder self-attention B32 x 376 frames with
   ragged key padding, decoder cross-attention 128 x 376, and B4 x 1501
   frames, a 60 s window, whose 128-row tiles move the dropout hash's
   coordinates), fp32 (TF32 off) and bf16, dropout 0 and 0.1 with one
   seed; forward outputs, L, dQ, dK and dV checked; every bf16 launch
   of the four went through a tensor-core kernel (variant "wgmma"), every
   fp32 one through a CUDA-core kernel ("simt"); two launches of dQ and
   dK/dV on the same bf16 inputs give bitwise-equal gradients; times as
   in phase 2 (dQ + dK/dV summed beside SDPA's whole backward), the host
   time of one call of each wrapper (µs, fp32 and bf16 at the encoder
   shape) and of the bare library call with either forward kernel on the
   same bf16 inputs;
4. main_path: the engine at the flagship width (d256, 4 heads, 12 + 6
   layers, FFN 1024, vocab 5000, CNN (256, 256); bf16, seeded random
   weights) serving B 16 x 10 s of PCM16 through translate,
   transcribe_and_translate and speaker_turns, plus one short beam-1 call;
   the kernels' launch counts are zeroed just before and read just after
   and must be exactly 2 x 1170 anc, 3 x 1170 cross and 1170 self launches
   (6 decoder layers x 195 steps per search), every bf16 decode launch on
   its split kernel; --profile also traces one warm beam-1 translate of
   the 2 utterances (the self kernel's device µs a launch in the loop);
5. train: the flagship training configuration as bench_train.py builds it
   (dropout 0.1, CTC 0.3, label smoothing 0.1, batchmean, AdamW 1e-3,
   WarmCoolDecay, clip 5.0, bf16 compute, B32 x 15 s, U128, seeded
   weights) through STTrainer.fit for one epoch of 6 copies of one batch,
   CMVN update on; counts zeroed just before and read just after (exactly
   18 training-forward, 18 dQ and 18 dK/dV launches a step, every one on
   a tensor-core kernel), then one eval forward (exactly 18
   flash_attention launches, all on the tensor-core kernel);
6. data_train: training from a manifest on disk, as
   recipes/train_multitask.py drives it: 128 utterances of 12-15 s of
   seeded audio at 8 kHz written to a temporary directory (PCM16 WAV,
   some entries two files, one mu-law SPHERE file; reference-schema
   manifest, ASR and ST rows with pseudo-word text, some [turn] and
   [turn] [xt]), a BPE tokenizer trained on its text (vocab >= 500;
   the model keeps vocab 5000), SpeechDataset at 16 kHz with
   DeviceSpeedPerturb([90, 100, 110]), the recipe's DynamicBatchSampler
   (450 s, 50 buckets, at most 128 rows, random order, shuffled) and
   BatchLoader (4 workers); STTrainer.fit for two epochs at the flagship
   width in bf16 with speed_perturb set. Checks: every batch as wide as
   its bucket and with a speed_idx column, the epochs draw different
   speeds, a second pass over epoch 1 gives identical batches, finite
   losses, exactly 18 training-forward, 18 dQ and 18 dK/dV launches a
   step, all on the tensor-core kernels, and the first batch's perturbed
   signal on the card (TF32 allowed by the caller) against the CPU within
   1e-5. Prints the loader's rate alone (1 and 4 workers, device and
   host perturbation) and its stages, a warm step on the largest batch,
   peak memory, and with --profile the idle share of that step;
7. card_vs_cpu: the port on the card against the port on the CPU, full
   width, fp32, 2 x 2 s: one decode step's logits and the token agreement
   of a short translate;
8. card_vs_cpu_train: one train step, full width d256/H4, 2 + 2 layers,
   B2 x 2 s, fp32 (TF32 off), dropout 0: loss, gradients and updated
   parameters, card against CPU; then the same for B3 x 2 s through
   DeviceSpeedPerturb, one row at each speed.

Then the card's name and power limit, a {"kernels": [...]} line (every
kernel names the variant its main-path launches went through),
and last
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. It needs the rest of the repository;
alone, or without a CUDA device, it fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM data-sheet peaks (dense): HBM bytes/s, FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the serving path's shapes: B 16 x 10 s, beam 10, flagship heads
B, BEAM, H, DH = 16, 10, 4, 64
S_SELF = 3 + 192          # prompt + max_decode_tokens
S_ENC = 251               # 1001 fbank frames after two stride-2 convs
SECONDS, SR = 10.0, 16000
# kernel vs plain version: fp32 sums the same products in another order
# (bound ~ n·2^-24 for n <= 251 terms of O(1)); bf16 outputs may differ by
# one bf16 step (2^-7 for |x| in [1, 2))
TOL = {"float32": 5e-5, "bfloat16": 1e-2}

# the training path's shapes (bench_train.py: B32 x 15 s): 15 s -> 1501
# fbank frames -> 376 encoder frames; U 128 decoder positions; a 60 s
# window -> 1501 encoder frames
TB, T_ENC, T_DEC, SECONDS_TRAIN, U_TRAIN = 32, 376, 128, 15.0, 128
TB_LONG, T_LONG = 4, 1501
TRAIN_SEED, P_DROP = 1234567, 0.1
# flash kernels vs plain versions, relative to max(1, max |plain|): fp32
# sums a few hundred products per output in another order (~n 2^-24);
# bf16 outputs may differ by one bf16 step (2^-7 relative) and the
# backward reads bf16-rounded inputs
TRAIN_TOL = {"float32": 5e-5, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, L2 flushed before each launch (the decode
    loop meets each layer's cache cold). A flush of 256 MB keeps the card
    busy while the host enqueues the timed call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")
        self.tiny = torch.empty(16, device="cuda")

    def ms(self, fn, n: int = 30) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(n):
            self.flush_l2()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.mean([a.elapsed_time(b) for a, b in pairs]))

    def flush_l2(self) -> None:
        self.flush.zero_()

    def floor_ms(self) -> float:
        """The timer's floor: one tiny kernel, timed as every call is."""
        return self.ms(self.tiny.zero_)


def host_us(torch, fn, n: int = 40, rounds: int = 5) -> float:
    """Host time of one call in µs: the median over rounds of the mean of n
    calls issued back to back (launches are asynchronous, so this is the
    caller's own cost, not the kernel's)."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        means.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return float(np.median(means))


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# SDPA's fused backends, each tried for the library yardstick
SDPA_FUSED = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_yardstick(torch, timer, q, k, v, want):
    """The library time of one attention call: scaled_dot_product_attention
    of q (..., Lq, Dh) against k, v (..., n, Dh), at scale 1, all three laid
    out contiguous as its fused backends take them (built by the caller,
    outside the timed call). Every fused backend that accepts the call is
    checked against ``want`` (the plain version's output in SDPA's layout;
    within bf16's step, since a backend may compute in bf16) and timed; the
    fastest is kept, with its name. The math path is timed only where no
    fused backend accepts the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    call = partial(F.scaled_dot_product_attention, q, k, v, scale=1.0)
    best = None
    for name in (*SDPA_FUSED, "MATH"):
        if name == "MATH" and best is not None:
            break
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:
                out = call()
                torch.cuda.synchronize()
            except RuntimeError:  # this backend refuses the call
                continue
            err = (out.float() - want.float()).abs().max().item()
            check(err <= TOL["bfloat16"], f"SDPA {name}: err {err}")
            ms = timer.ms(call)
        if best is None or ms < best["library_ms"]:
            best = {"library_ms": ms, "library_backend": name.lower()}
    return best


def _self_lib(q, k, v, idx, want):
    """SDPA's inputs for self attention over positions 0..idx, and the
    plain version's output in its layout."""
    n = idx + 1
    return (q[:, :, None], k[..., :n].transpose(-1, -2).contiguous(),
            v[:, :, :n].contiguous(), want[:, :, None])


def _cross_lib(q, kT, v, beam, want):
    """SDPA's inputs for the beam queries of each utterance against its
    K/V, and the plain version's output in its layout."""
    BB, H, Dh = q.shape

    def lay(t):
        return t.reshape(BB // beam, beam, H, Dh).transpose(1, 2).contiguous()

    return lay(q), kT.transpose(-1, -2).contiguous(), v, lay(want)


def kernel_phase(torch, K, timer):
    """Each kernel vs its plain version at the serving shapes."""
    from stac_st_tpu_torch.ops import kernels

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    BB = B * BEAM
    idx = S_SELF - 1
    n = idx + 1
    anc_cpu = torch.randint(0, BEAM, (B, BEAM, S_SELF), generator=g,
                            dtype=torch.int32)
    # the positions the ancestor table makes the anc kernel read
    uniq = sum(int(torch.unique(anc_cpu[b, :, s]).numel())
               for b in range(B) for s in range(n))
    base = {
        "self": (randn(BB, H, DH) / 8, randn(BB, H, DH, S_SELF),
                 randn(BB, H, S_SELF, DH)),
        "anc": (randn(BB, H, DH) / 8, randn(BB, H, S_SELF, DH),
                randn(BB, H, S_SELF, DH)),
        "cross": (randn(BB, H, DH) / 8, randn(B, H, DH, S_ENC),
                  randn(B, H, S_ENC, DH)),
    }
    rows = []
    for name, key in (("decode_self_attention", "self"),
                      ("decode_self_attention_anc", "anc"),
                      ("decode_cross_attention", "cross")):
        rec = {"phase": "kernel", "name": name}
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v = (t.to("cuda", dt).contiguous() for t in base[key])
            anc = anc_cpu.to("cuda")
            es = q.element_size()
            if key == "self":
                run = partial(K.decode_self_attention, q, k, v, idx)
                plain = partial(K.decode_self_attention_ref, q, k, v, idx)
                lib = partial(_self_lib, q, k, v, idx)
                nbytes = (2 * BB * H * DH + 2 * BB * H * n * DH) * es
                flops = 4.0 * BB * H * n * DH
            elif key == "anc":
                run = partial(K.decode_self_attention_anc, q, k, v, anc, idx,
                              BEAM)
                plain = partial(K.decode_self_attention_anc_ref, q, k, v, anc,
                                idx, BEAM)
                lib = None  # no single library call selects ancestors
                nbytes = (2 * BB * H * DH + 2 * uniq * H * DH) * es \
                    + B * BEAM * n * 4
                flops = 4.0 * BB * H * n * DH
            else:
                run = partial(K.decode_cross_attention, q, k, v, None, BEAM)
                plain = partial(K.decode_cross_attention_ref, q, k, v, None,
                                BEAM)
                lib = partial(_cross_lib, q, k, v, BEAM)
                nbytes = (2 * BB * H * DH + 2 * B * H * S_ENC * DH) * es
                flops = 4.0 * BB * H * S_ENC * DH
                # the padding-bias variant is checked too (not timed): key
                # lengths that leave whole 32-key splits masked, and 0,
                # a row whose every key is masked (uniform softmax)
                bias = torch.where(
                    torch.arange(S_ENC, device="cuda")[None, :]
                    < torch.tensor([S_ENC, 200, 31, 0] * 4,
                                   device="cuda")[:, None], 0.0, -1e9)
                err_b = (K.decode_cross_attention(q, k, v, bias, BEAM).float()
                         - K.decode_cross_attention_ref(q, k, v, bias, BEAM)
                         .float()).abs().max().item()
                check(err_b <= TOL[dtype],
                      f"{name} {dtype} with bias: err {err_b}")
            before = dict(kernels.launches)
            out = run()
            torch.cuda.synchronize()
            # the kernel the dispatch rule names
            want = SPLIT if dtype == "bfloat16" else "simt"
            got = {kn: c - before.get(kn, 0)
                   for kn, c in kernels.launches.items()}
            check(got.get(f"{name}/{want}") == 1, f"{name} {dtype}: "
                  f"launched {got}, want {want}")
            want_out = plain()
            err = (out.float() - want_out.float()).abs().max().item()
            check(bool(torch.isfinite(out).all()), f"{name} {dtype} finite")
            check(err <= TOL[dtype],
                  f"{name} {dtype}: max abs err {err} > {TOL[dtype]}")
            if dtype == "bfloat16":
                # split kernels: the splits are combined in rank order, so
                # two launches give the same bits
                again = run()
                torch.cuda.synchronize()
                check(torch.equal(out, again), f"{name} not repeatable")
                rec["bitwise_repeatable"] = True
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            rec[dtype] = {
                "max_abs_err": err, "tol": TOL[dtype], "variant": want,
                "ms": timer.ms(run), "plain_ms": timer.ms(plain),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                # the wrapper's own cost a call: checks, ctypes, the launch
                # (a cluster launch for split, <<<>>> for simt)
                "host_us": host_us(torch, run),
            }
            if lib is not None:
                rec[dtype].update(sdpa_yardstick(torch, timer,
                                                 *lib(want_out)))
        rec["timer_floor_ms"] = timer.floor_ms()
        if key == "self":
            for S, i in ((S_SELF, S_SELF - 1), (131, 97)):
                rec[f"bfloat16_rows16_idx{i}"] = _self_greedy(torch, K, timer,
                                                               g, S, i)
        elif key == "anc":
            rec["bfloat16_idx97"] = _anc_mid(torch, K, timer, g)
        elif key == "cross":
            rec["bfloat16_b32"] = _cross_b32(torch, K, timer, g)
        emit(rec)
        rows.append(rec)
    return rows


def _timed_case(torch, timer, name, label, run, plain, nbytes, flops,
                lib=None):
    """A bf16 case of kernel ``name``: error, the split variant launched,
    repeatability, times, the timer's floor; ``lib`` makes the SDPA
    yardstick from the plain version's output, or is None."""
    from stac_st_tpu_torch.ops import kernels

    before = dict(kernels.launches)
    out = run()
    torch.cuda.synchronize()
    added = {kn: c - before.get(kn, 0) for kn, c in kernels.launches.items()
             if c != before.get(kn, 0)}
    check(added == {name: 1, f"{name}/{SPLIT}": 1},
          f"{label}: launched {added}")
    want = plain()
    err = (out.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(out).all()), f"{label} finite")
    check(err <= TOL["bfloat16"], f"{label}: max abs err {err}")
    check(torch.equal(out, run()), f"{label} not repeatable")
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    rec = {"max_abs_err": err, "tol": TOL["bfloat16"], "variant": SPLIT,
           "bitwise_repeatable": True, "ms": timer.ms(run),
           "plain_ms": timer.ms(plain), "library_ms": None,
           "bound_ms": b_ms, "bound_by": b_by,
           "timer_floor_ms": timer.floor_ms()}
    if lib is not None:
        rec.update(sdpa_yardstick(torch, timer, *lib(want)))
    return rec


def _self_greedy(torch, K, timer, g, S, idx):
    """self at a shape greedy serving gives it: B16 beam 1, 16 rows, at
    position idx of an S-position cache segment."""
    n = idx + 1
    bf = torch.bfloat16
    q, kT, v = ((torch.randn(shape, generator=g) * sc).to("cuda", bf)
                for shape, sc in (((B, H, DH), 1 / 8), ((B, H, DH, S), 1),
                                  ((B, H, S, DH), 1)))
    return _timed_case(
        torch, timer, "decode_self_attention", f"self 16 rows idx {idx}",
        partial(K.decode_self_attention, q, kT, v, idx),
        partial(K.decode_self_attention_ref, q, kT, v, idx),
        (2 * B * H * DH + 2 * B * H * n * DH) * 2, 4.0 * B * H * n * DH,
        lib=partial(_self_lib, q, kT, v, idx))


def _anc_mid(torch, K, timer, g):
    """anc mid-decode: idx 97 (the main path's mean over 195 steps) sits in
    the second cache segment, 3 + 128 = 131 positions."""
    S, idx, BB = 131, 97, B * BEAM
    n = idx + 1
    bf = torch.bfloat16
    q, k, v = ((torch.randn(shape, generator=g) * sc).to("cuda", bf)
               for shape, sc in (((BB, H, DH), 1 / 8), ((BB, H, S, DH), 1),
                                 ((BB, H, S, DH), 1)))
    anc = torch.randint(0, BEAM, (B, BEAM, S), generator=g,
                        dtype=torch.int32)
    uniq = sum(int(torch.unique(anc[b, :, s]).numel())
               for b in range(B) for s in range(n))
    anc = anc.to("cuda")
    nbytes = (2 * BB * H * DH + 2 * uniq * H * DH) * 2 + B * BEAM * n * 4
    return _timed_case(
        torch, timer, "decode_self_attention_anc", "anc idx 97",
        partial(K.decode_self_attention_anc, q, k, v, anc, idx, BEAM),
        partial(K.decode_self_attention_anc_ref, q, k, v, anc, idx, BEAM),
        nbytes, 4.0 * BB * H * n * DH)


def _cross_b32(torch, K, timer, g):
    """cross at the dual search's shape: call_multi tiles the encoder
    output, so B 32 utterance rows of 251 frames."""
    B2 = 2 * B
    bf = torch.bfloat16
    q, kT, v = ((torch.randn(shape, generator=g) * sc).to("cuda", bf)
                for shape, sc in (((B2 * BEAM, H, DH), 1 / 8),
                                  ((B2, H, DH, S_ENC), 1),
                                  ((B2, H, S_ENC, DH), 1)))
    nbytes = (2 * B2 * BEAM * H * DH + 2 * B2 * H * S_ENC * DH) * 2
    return _timed_case(
        torch, timer, "decode_cross_attention", "cross B32",
        partial(K.decode_cross_attention, q, kT, v, None, BEAM),
        partial(K.decode_cross_attention_ref, q, kT, v, None, BEAM),
        nbytes, 4.0 * B2 * BEAM * H * S_ENC * DH,
        lib=partial(_cross_lib, q, kT, v, BEAM))


def _flash_bounds(name, B, Tq, Tk, es):
    """(bytes, flops) a flash kernel must move and do: each input read
    once, each output written once; scores are recomputed, not stored."""
    qo, kv = B * Tq * H * DH * es, B * Tk * H * DH * es
    rows, bias = B * H * Tq * 4, B * Tk * 4
    mm = 2.0 * B * H * Tq * Tk * DH  # one (Tq x Tk x Dh) product
    if name == "flash_attention":
        return 2 * qo + 2 * kv + bias, 2 * mm
    if name == "flash_attention_train_fwd":
        return 2 * qo + 2 * kv + bias + rows, 2 * mm
    if name == "flash_attention_train_dq":  # q, dO, k, v, L, delta -> dq
        return 3 * qo + 2 * kv + bias + 2 * rows, 3 * mm
    return 2 * qo + 4 * kv + bias + 2 * rows, 4 * mm  # -> dk, dv


SPLIT = "split"  # the decode kernels' variant for bf16 / fp16
DECODE_SPLIT = ("decode_self_attention", "decode_self_attention_anc",
                "decode_cross_attention")
# the split decode kernels and their instantiations (ptxas: no spills)
SPLIT_KERNELS = {"self_split_kernel": 2, "cross_split_kernel": 2,
                 "anc_split_kernel": 2}
FLASH = ("flash_attention", "flash_attention_train_fwd",
         "flash_attention_train_dq", "flash_attention_train_dkv")
TC = "wgmma"     # the tensor-core kernels' variant (bf16 / fp16, Dh 64)
VARIANTS = (TC, "simt")
# the tensor-core kernels and their instantiations (ptxas: no spills)
TC_KERNELS = {"fwd_tc_kernel": 4, "dq_tc_kernel": 2, "dkv_tc_kernel": 2}


def spills(log: str, kernel: str):
    """{mangled name: (spill store bytes, spill load bytes)} of every
    instantiation of ``kernel`` in an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            name = ln.split("Function properties for ", 1)[1].strip()
        elif name is not None and "spill stores" in ln:
            if kernel in name:
                nums = [int(w) for w in ln.replace(",", " ").split()
                        if w.isdigit()]
                out[name] = (nums[1], nums[2])  # stack, stores, loads
            name = None
    return out


def registers(log: str, kernel: str):
    """{mangled name: registers} of every instantiation of ``kernel`` in
    an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            name = ln.split("'")[1]
        elif name is not None and "Used " in ln and " registers" in ln:
            if kernel in name:
                out[name] = int(ln.split("Used ", 1)[1].split()[0])
            name = None
    return out


def train_kernel_phase(torch, kernels, timer):
    """The four flash kernels vs their plain versions at the training
    shapes; bf16 times at the encoder and cross shapes."""
    import torch.nn.functional as F

    from stac_st_tpu_torch.ops.kernels import attention as A
    from stac_st_tpu_torch.ops.kernels import train_attention as TA

    g = torch.Generator(device="cpu").manual_seed(1)
    cases = {"encoder_self": (TB, T_ENC, T_ENC),
             "decoder_cross": (TB, T_DEC, T_ENC),
             "multi_tile": (TB_LONG, T_LONG, T_LONG)}
    recs = {n: {"phase": "train_kernel", "name": n} for n in FLASH}

    def err(got, want):
        """(max abs error, max abs error / max(1, max |want|))"""
        e = float((got.float() - want.float()).abs().max())
        return e, e / max(1.0, float(want.float().abs().max()))

    for case, (B, Tq, Tk) in cases.items():
        base = [torch.randn((B, Tq, H, DH), generator=g),
                torch.randn((B, Tk, H, DH), generator=g),
                torch.randn((B, Tk, H, DH), generator=g),
                torch.randn((B, Tq, H, DH), generator=g)]
        lens = torch.randint(Tk // 2, Tk + 1, (B,), generator=g)
        lens[0] = Tk
        bias = torch.where(torch.arange(Tk)[None, :] < lens[:, None], 0.0,
                           -1e9).float().to("cuda")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q, k, v, do = (t.to("cuda", dt).contiguous() for t in base)
            want = TC if dtype == "bfloat16" else "simt"
            check(TA.flash_variant(dt, DH) == want, f"dispatch {dtype}")
            for p in (0.0, P_DROP):
                kernels.reset_launches()
                out, lse = TA.flash_attention_train_fwd(q, k, v, bias,
                                                        TRAIN_SEED, p)
                o_ref, l_ref = TA.flash_attention_train_fwd_ref(
                    q, k, v, bias, TRAIN_SEED, p)
                delta = TA.row_delta(do, o_ref)
                args = (q, k, v, bias, TRAIN_SEED, p, do, l_ref, delta)
                dq = TA.flash_attention_train_dq(*args)
                dk, dv = TA.flash_attention_train_dkv(*args)
                torch.cuda.synchronize()
                dk_r, dv_r = TA.flash_attention_train_dkv_ref(*args)
                errs = {
                    "flash_attention_train_fwd": max(err(out, o_ref),
                                                     err(lse, l_ref),
                                                     key=lambda x: x[1]),
                    "flash_attention_train_dq": err(
                        dq, TA.flash_attention_train_dq_ref(*args)),
                    "flash_attention_train_dkv": max(err(dk, dk_r),
                                                     err(dv, dv_r),
                                                     key=lambda x: x[1]),
                }
                if p == 0.0:
                    o = A.flash_attention(q, k, v, bias)
                    torch.cuda.synchronize()
                    errs["flash_attention"] = err(
                        o, A.flash_attention_ref(q, k, v, bias))
                for name in FLASH:
                    n = kernels.launches.get(name, 0)
                    check(kernels.launches.get(f"{name}/{want}", 0) == n,
                          f"{name} {case} {dtype}: {kernels.launches}")
                if dtype == "bfloat16":  # no atomics: bitwise repeatable
                    again = (TA.flash_attention_train_dq(*args),
                             *TA.flash_attention_train_dkv(*args))
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b)
                              for a, b in zip((dq, dk, dv), again)),
                          f"backward not deterministic {case} p={p}")
                    recs["flash_attention_train_dq"].setdefault(
                        "bitwise_repeatable", []).append(f"{case}/p{p}")
                for name, (e_abs, e) in errs.items():
                    check(e <= TRAIN_TOL[dtype],
                          f"{name} {case} {dtype} p={p}: rel err {e}")
                    key = f"{case}/{dtype}/p{p}"
                    recs[name].setdefault("rel_err", {})[key] = e
                    recs[name].setdefault("abs_err", {})[key] = e_abs
            # the backward's inputs at the main path's dropout rate
            args = (q, k, v, bias, TRAIN_SEED, P_DROP, do, l_ref, delta)
            if case == "encoder_self":  # each wrapper's host cost
                for name, run in (
                        ("flash_attention",
                         partial(A.flash_attention, q, k, v, bias)),
                        ("flash_attention_train_fwd",
                         partial(TA.flash_attention_train_fwd, q, k, v,
                                 bias, TRAIN_SEED, P_DROP)),
                        ("flash_attention_train_dq",
                         partial(TA.flash_attention_train_dq, *args)),
                        ("flash_attention_train_dkv",
                         partial(TA.flash_attention_train_dkv, *args))):
                    recs[name].setdefault("host_us", {})[
                        f"{dtype}/{want}"] = host_us(torch, run)
                if dtype == "bfloat16":  # the library call alone, each kernel
                    lb, o_buf = TA.lib(), torch.empty_like(q)
                    l_buf = torch.empty((B, H, Tq), dtype=torch.float32,
                                        device="cuda")
                    c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              bias.data_ptr(), o_buf.data_ptr(),
                              l_buf.data_ptr(),
                              B, H, Tq, Tk, DH, *TA.drop_args(
                                  1 / math.sqrt(DH), TRAIN_SEED, P_DROP, Tq,
                                  Tk, dt))
                    for variant, tc in ((TC, 1), ("simt", 0)):
                        call = partial(lb.stac_flash_fwd, *c_args, tc)
                        check(call() == 0, f"stac_flash_fwd {variant}")
                        recs["flash_attention_train_fwd"].setdefault(
                            "c_call_host_us", {})[f"{dtype}/{variant}"] = (
                                host_us(torch, call))
            if dtype != "bfloat16" or case == "multi_tile":
                continue
            # times at the main path's type and dropout rate
            es = q.element_size()
            qh, kh, vh, doh = (t.transpose(1, 2).contiguous().requires_grad_()
                               for t in (q, k, v, do))
            mask = bias.to(dt)[:, None, None, :]
            lib_out = F.scaled_dot_product_attention(qh, kh, vh, mask,
                                                     dropout_p=P_DROP)
            calls = {
                "flash_attention": (
                    partial(A.flash_attention, q, k, v, bias),
                    partial(A.flash_attention_ref, q, k, v, bias),
                    partial(F.scaled_dot_product_attention, qh, kh, vh,
                            mask)),
                "flash_attention_train_fwd": (
                    partial(TA.flash_attention_train_fwd, q, k, v, bias,
                            TRAIN_SEED, P_DROP),
                    partial(TA.flash_attention_train_fwd_ref, q, k, v, bias,
                            TRAIN_SEED, P_DROP),
                    partial(F.scaled_dot_product_attention, qh, kh, vh,
                            mask, dropout_p=P_DROP)),
            }
            lib_bwd = partial(torch.autograd.grad, lib_out, (qh, kh, vh), doh,
                              retain_graph=True)
            calls["flash_attention_train_dq"] = (
                partial(TA.flash_attention_train_dq, *args),
                partial(TA.flash_attention_train_dq_ref, *args), lib_bwd)
            calls["flash_attention_train_dkv"] = (
                partial(TA.flash_attention_train_dkv, *args),
                partial(TA.flash_attention_train_dkv_ref, *args), lib_bwd)
            for name, (run, plain, lib) in calls.items():
                nbytes, flops = _flash_bounds(name, B, Tq, Tk, es)
                b_ms, b_by = bound_ms(nbytes, flops, dtype)
                recs[name][case] = {
                    "shape": [B, Tq, Tk, H, DH], "dtype": dtype,
                    "p_drop": 0.0 if name == "flash_attention" else P_DROP,
                    "ms": timer.ms(run, 20), "plain_ms": timer.ms(plain, 5),
                    # dq and dkv: one autograd backward computes dq, dk, dv
                    "library_ms": timer.ms(lib, 10),
                    "bound_ms": b_ms, "bound_by": b_by}
            # the whole backward, ours beside the library's in this run
            bwd_ms = (recs["flash_attention_train_dq"][case]["ms"]
                      + recs["flash_attention_train_dkv"][case]["ms"])
            for name in ("flash_attention_train_dq",
                         "flash_attention_train_dkv"):
                recs[name][case]["dq_plus_dkv_ms"] = bwd_ms
            del qh, kh, vh, doh, lib_out
    for rec in recs.values():
        rec["tol_rel"] = TRAIN_TOL
        emit(rec)
    return [recs[n] for n in FLASH]


class SyntheticTokenizer:
    """Duck-typed tokenizer for seeded random weights: language tags map
    to fixed ids, every other id to a word of its own."""

    LANGS = {"[es]": 3, "[en]": 4}

    def encode_as_ids(self, text):
        return [self.LANGS[text]]

    def decode_ids(self, ids):
        return " ".join(f"w{i}" for i in ids)


def flagship(seed: int, enc: int = 12, dec: int = 6, dropout: float = 0.1):
    """The flagship preset's modules with seeded Glorot weights (CPU);
    ``enc``/``dec`` cut the depth only."""
    import torch

    from stac_st_tpu_torch.models import (
        ConvolutionFrontEnd,
        LinearHead,
        TransformerMultiTask,
        glorot_init_,
    )

    mods = dict(
        transformer=TransformerMultiTask(
            5000, 5120, d_model=256, nhead=4, num_encoder_layers=enc,
            num_decoder_layers=dec, d_ffn=1024, dropout=dropout),
        cnn=ConvolutionFrontEnd(out_channels=(256, 256), dropout=dropout),
        seq_lin=LinearHead(256, 5000),
        ctc_lin=LinearHead(256, 5000),
    )
    gen = torch.Generator().manual_seed(seed)
    for m in mods.values():
        glorot_init_(m, gen)
    return mods


def engine(mods, device, **kw):
    from stac_st_tpu_torch.ops.cmvn import cmvn_init
    from stac_st_tpu_torch.serving import STEngine

    return STEngine(mods["transformer"], mods["cnn"], mods["seq_lin"],
                    mods["ctc_lin"], cmvn_init(80), SyntheticTokenizer(),
                    device=device, **kw)


def serving_wavs():
    """B PCM16 inputs of SECONDS each, seeded noise."""
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(int(SECONDS * SR)) * 3000)
            .clip(-32768, 32767).astype(np.int16) for _ in range(B)]


def beam1_engine(mods):
    """Greedy serving at the main path's settings: bf16, at most 192
    tokens, PCM16 transfer."""
    return engine(mods, "cuda", bf16=True, beam_size=1,
                  max_decode_tokens=192, transfer_dtype="int16")


def main_path_phase(torch, kernels, profile: bool):
    wavs = serving_wavs()
    audio_s = B * SECONDS
    mods = flagship(0)
    eng = engine(mods, "cuda", bf16=True, beam_size=BEAM,
                 max_decode_tokens=192, transfer_dtype="int16")
    eng1 = beam1_engine(mods)
    rec = {"phase": "main_path", "batch": B, "seconds": SECONDS,
           "beam": BEAM}
    kernels.reset_launches()
    t0 = time.perf_counter()
    st = eng.translate(wavs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    asr, st2 = eng.transcribe_and_translate(wavs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    turns = eng.speaker_turns(wavs)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    st1 = eng1.translate(wavs[:2])
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = dict(kernels.launches)
    check(len(st) == len(asr) == len(st2) == len(turns) == B,
          "one output per input")
    check(all(isinstance(x, str) and x for x in st + asr + st2),
          "non-empty texts")
    check(len(st1) == 2 and all(st1), "beam-1 texts")
    # 6 decoder layers x (3 prompt + 192) steps per search: anc in translate
    # and the dual search, cross in those and the beam-1 call, self in the
    # beam-1 call only; the serving dtype is bf16, so every decode launch is
    # a split kernel's
    per_search = 6 * S_SELF
    want = {"decode_self_attention": per_search,
            "decode_self_attention_anc": 2 * per_search,
            "decode_cross_attention": 3 * per_search}
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{name}: {launches.get(name, 0)} launches, want {n}")
    for name in DECODE_SPLIT:
        check(launches.get(f"{name}/{SPLIT}", 0) == want[name],
              f"{name} on the split kernel: {launches}")
    rec.update({
        "translate_s": t1 - t0, "translate_rtfx": audio_s / (t1 - t0),
        "dual_s": t2 - t1, "dual_rtfx": audio_s / (t2 - t1),
        "speaker_turns_s": t3 - t2, "beam1_translate_2x10s_s": t4 - t3,
        "launches": launches,
        "tokens_per_utt": [len(s.split()) for s in st],
        # bf16 matmuls at 2x the rows may round differently, so the fused
        # dual search is not required to reproduce translate bit for bit
        "dual_st_equals_translate": sum(a == b for a, b in zip(st2, st)),
    })
    # steady state: the same call again, caches and autotuning warm
    t5 = time.perf_counter()
    again = eng.translate(wavs)
    torch.cuda.synchronize()
    t6 = time.perf_counter()
    rec["repeat_identical"] = again == st
    rec["translate_warm_s"] = t6 - t5
    rec["translate_warm_rtfx"] = audio_s / (t6 - t5)
    if profile:
        rec["profile"] = profile_call(
            torch, lambda: eng.translate(wavs), t6 - t5, "translate",
            watch=("anc_split_kernel", "cross_split_kernel"))
        rec["profile_beam1"] = profile_beam1(torch, eng1, wavs[:2],
                                             "translate_beam1")
    emit(rec)
    return rec


# the self kernel's names in a trace: split (bf16/fp16) and the two-pass one
# (fp32; every dtype in trees before the split kernel)
SELF_KERNELS = ("self_split_kernel<", "self_kernel<")


def profile_beam1(torch, eng1, wavs, name: str):
    """One warm beam-1 translate of ``wavs`` traced, after one call that
    warms the caches and one timed without the profiler: the self and
    cross kernels' device µs a launch in the decode loop."""
    eng1.translate(wavs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng1.translate(wavs)
    torch.cuda.synchronize()
    return profile_call(torch, lambda: eng1.translate(wavs),
                        time.perf_counter() - t0, name,
                        watch=(*SELF_KERNELS, "cross_split_kernel"))


def profile_call(torch, fn, wall_unprofiled: float, name: str,
                 watch=()):
    """Device time by kernel over one call of ``fn`` (the union of kernel
    and copy intervals is the busy time; the idle share is taken against
    the same call's wall time without the profiler). The table goes to
    chiprun_out/profile_<name>.txt. ``watch``: name fragments whose kernels
    are summed into device µs, launches and µs a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40))
    spans, by_name, launches = [], {}, {}
    for ev in prof.events():
        # device work only; CUPTI's own buffer requests are not the program's
        if ev.device_type != DeviceType.CUDA or \
                ev.name.startswith("Activity Buffer"):
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us()
        launches[ev.name] = launches.get(ev.name, 0) + 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    watched = {}
    for frag in watch:
        names = [k for k in by_name if frag in k]
        us, count = sum(by_name[k] for k in names), sum(launches[k]
                                                         for k in names)
        if count:
            watched[frag.rstrip("<")] = {"device_us": us, "launches": count,
                                         "us_per_launch": us / count}
    return {"wall_profiled_s": wall, "wall_unprofiled_s": wall_unprofiled,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_unprofiled,
            "top_device_us": [[k[:60], v, launches[k]] for k, v in top],
            "watched": watched}


def _train_batch(rng, B, samples, U):
    """A PaddedBatch as bench_train.py makes its batch: unit-variance
    noise at full length, random tokens, token lengths 0.9."""
    from stac_st_tpu_torch.data.dataset import PaddedBatch, _PaddedPair

    def toks():
        return rng.integers(3, 5000, (B, U)).astype(np.int32)

    tl = np.full((B,), 0.9, np.float32)
    return PaddedBatch(
        id=[f"u{i}" for i in range(B)],
        sig=_PaddedPair(rng.standard_normal((B, samples)).astype(np.float32),
                        np.ones((B,), np.float32)),
        tokens=_PaddedPair(toks(), tl), tokens_bos=_PaddedPair(toks(), tl),
        tokens_eos=_PaddedPair(toks(), tl),
        duration=[samples / SR] * B, task=["translation"] * B,
        source_lang=["es"] * B, target_lang=["en"] * B)


def _trainer(torch, mods, bf16: bool, speed_perturb=None):
    from stac_st_tpu_torch.ops.cmvn import InputNormalization
    from stac_st_tpu_torch.ops.fbank import Fbank
    from stac_st_tpu_torch.training.optim import AdamW
    from stac_st_tpu_torch.training.schedulers import WarmCoolDecayLRSchedule
    from stac_st_tpu_torch.training.trainer import STTrainer

    modules = {"CNN": mods["cnn"], "Transformer": mods["transformer"],
               "seq_lin": mods["seq_lin"], "ctc_lin": mods["ctc_lin"],
               "normalize": InputNormalization(update_until_epoch=4)}
    hparams = dict(
        compute_features=Fbank(), ctc_weight=0.3, label_smoothing=0.1,
        loss_reduction="batchmean", auto_mix_prec=bf16, seed=0,
        lr_scheduler=WarmCoolDecayLRSchedule(1e-3, 1000, 1000, 100000,
                                             decay_every=10000),
        use_grad_clipping=True, max_grad_norm=5.0,
        speed_perturb=speed_perturb)
    return STTrainer(modules, AdamW(lr=1e-3), hparams, device="cuda")


def train_phase(torch, kernels, profile: bool):
    """STTrainer.fit at the flagship width over 6 copies of one batch."""
    from stac_st_tpu_torch.ops.specaugment import (
        apply_spec_augment,
        draw_spec_augment,
    )

    rng = np.random.default_rng(0)
    batch = _train_batch(rng, TB, int(SECONDS_TRAIN * SR), U_TRAIN)
    trainer = _trainer(torch, flagship(0), bf16=True)
    marks = []

    def copies(n=6):
        for _ in range(n):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield batch
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer.fit([1], copies())
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    steps = np.diff(marks)
    losses = [float(x) for x in trainer.epoch_losses]
    check(len(losses) == 6 and all(np.isfinite(losses)), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in FLASH[1:]:
        check(launches.get(name, 0) == 18 * 6,
              f"{name}: {launches.get(name, 0)} launches, want 18 a step")
        check(launches.get(f"{name}/{TC}", 0) == 18 * 6,
              f"{name} on the tensor cores: {launches}")
    check(launches.get("flash_attention", 0) == 0, "no eval kernel in fit")
    state = trainer.state
    check(state.optimizer_step == 6 and state.micro_step == 6, "counters")
    check(float(state.cmvn.count) == 6 * TB, "CMVN update")
    dev_batch = trainer._device_batch(batch)
    kernels.reset_launches()
    p_ctc, p_seq, enc = trainer.eval_forward(state.params, state.cmvn,
                                             dev_batch)
    torch.cuda.synchronize()
    eval_launches = dict(kernels.launches)
    check(eval_launches == {"flash_attention": 18,
                             f"flash_attention/{TC}": 18},
          f"eval forward launches {eval_launches}")
    check(tuple(p_seq.shape) == (TB, U_TRAIN, 5000)
          and tuple(p_ctc.shape) == (TB, T_ENC, 5000)
          and bool(torch.isfinite(p_seq).all())
          and bool(torch.isfinite(p_ctc).all()), "eval outputs")
    # SpecAugment (not in bench_train's configuration) on the card vs CPU
    feats = trainer.cfg.fbank(dev_batch["sig"])
    params = draw_spec_augment(tuple(feats.shape),
                               torch.Generator().manual_seed(5))
    aug_err = float((apply_spec_augment(feats, params).cpu()
                     - apply_spec_augment(feats.cpu(), params)).abs().max())
    check(aug_err <= 1e-3, f"SpecAugment card vs CPU: err {aug_err}")
    warm = float(np.median(steps[2:]))
    rec = {"phase": "train", "batch": TB, "seconds": SECONDS_TRAIN,
           "dtype": "bfloat16", "dropout": 0.1, "steps": len(steps),
           "step_ms": [x * 1e3 for x in steps], "warm_step_ms": warm * 1e3,
           "audio_s_per_s": TB * SECONDS_TRAIN / warm,
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "launches_fit": launches, "launches_eval": eval_launches,
           "specaugment_card_vs_cpu_err": aug_err}
    if profile:
        seed = trainer.next_seed()
        t0 = time.perf_counter()
        trainer.train_step(state, dev_batch, seed)
        torch.cuda.synchronize()
        rec["profile"] = profile_call(
            torch, lambda: trainer.train_step(state, dev_batch, seed),
            time.perf_counter() - t0, "train_step")
    emit(rec)
    return rec, {**launches, **eval_launches}


# the data phase: a telephone-speech corpus written to disk (Fisher /
# CallHome audio is 8 kHz), read at 16 kHz through the recipe's loader
# (recipes/hparams/transformer_multitask.yaml:188-190, 214-223)
N_CORPUS, FILE_SR, SPEEDS = 128, 8000, (90, 100, 110)
LOADER = dict(max_batch_length=450, num_buckets=50, max_batch_ex=128,
              batch_ordering="random", shuffle=True)
# device resample, card vs CPU: fp32 sums of at most 31 taps of O(1)
# values in another order (JAX runs the same convolution at HIGHEST)
RESAMPLE_ATOL = 1e-5


def ulaw_bytes(pcm: np.ndarray) -> bytes:
    """G.711 mu-law coding of int16 samples."""
    x = pcm.astype(np.int32)
    mag = np.minimum(np.abs(x), 32635) + 0x84
    exp = np.floor(np.log2(mag)).astype(np.int32) - 7
    mant = (mag >> (exp + 3)) & 0x0F
    code = ((x < 0).astype(np.int32) << 7) | (exp << 4) | mant
    return (~code & 0xFF).astype(np.uint8).tobytes()


def write_ulaw_sphere(path: str, wav: np.ndarray, rate: int) -> None:
    """A NIST SPHERE file of mu-law samples, as LDC ships telephone audio."""
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    header = (f"NIST_1A\n   1024\nsample_rate -i {rate}\n"
              "channel_count -i 1\nsample_n_bytes -i 1\n"
              "sample_coding -s4 ulaw\nend_head\n").encode()
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + ulaw_bytes(pcm))


def write_corpus(root: str, seed: int = 0):
    """N_CORPUS utterances of 12-15 s of seeded noise-and-tone audio at
    8 kHz, as PCM16 WAV (every eighth entry two files that the loader
    concatenates; one entry a mu-law SPHERE file), a training manifest in
    the reference schema (half ASR rows, half ES->EN rows; pseudo-word
    text, some rows with [turn] or [turn] [xt]) and the joint text lines
    for the tokenizer. Returns (manifest path, joint lines, audio s)."""
    from stac_st_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    syll = ["ba", "ce", "di", "fo", "gu", "la", "me", "ni", "po", "qui",
            "ra", "se", "ti", "vo", "za", "cha", "lle", "rro", "ñu", "que"]

    def lexicon(n):
        return ["".join(rng.choice(syll, rng.integers(1, 4)))
                for _ in range(n)]

    es, en = lexicon(400), [w[::-1] for w in lexicon(400)]
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    entries, lines, total = {}, [], 0.0
    for i in range(N_CORPUS):
        dur = float(rng.uniform(12.0, 15.0))
        n = int(dur * FILE_SR)
        t = np.arange(n) / FILE_SR
        wav = (0.2 * np.sin(2 * np.pi * (150 + 7 * (i % 40)) * t)
               + 0.05 * rng.standard_normal(n)).astype(np.float32)
        name = f"{{data_root}}/wav/u{i:03d}"
        if i == 5:
            write_ulaw_sphere(os.path.join(root, "wav", f"u{i:03d}.sph"),
                              wav, FILE_SR)
            files = [name + ".sph"]
        elif i % 8 == 3:
            cut = n // 2
            for part, piece in (("a", wav[:cut]), ("b", wav[cut:])):
                write_wav(os.path.join(root, "wav", f"u{i:03d}{part}.wav"),
                          piece, FILE_SR)
            files = [name + "a.wav", name + "b.wav"]
        else:
            write_wav(os.path.join(root, "wav", f"u{i:03d}.wav"), wav,
                      FILE_SR)
            files = [name + ".wav"]
        k = int(2.5 * dur)
        idx = rng.integers(0, 400, k)
        src = [es[j] for j in idx]
        tgt = [en[j] for j in idx]
        if i % 5 == 0:
            src.insert(k // 2, "[turn]")
            tgt.insert(k // 2, "[turn]")
        if i % 7 == 0:
            src.insert(k // 3, "[turn] [xt]")
            tgt.insert(k // 3, "[turn] [xt]")
        src, tgt = " ".join(src), " ".join(tgt)
        asr = i % 2 == 0
        start = i * 1500
        uid = f"conv{i % 16:02d}-A-{start:06d}-{start + int(dur * 100):06d}"
        entries[uid] = {
            "wav": " ".join(files), "duration": n / FILE_SR,
            "task": "transcription" if asr else "translation",
            "source_lang": "es", "target_lang": "es" if asr else "en",
            "transcription": src, "translation_0": src if asr else tgt,
            "transcription_and_translation": f"{src} {tgt}"}
        lines.append(f"{src} {tgt}")
        total += n / FILE_SR
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        json.dump(entries, f, indent=1)
    return path, lines, total


def corpus_loader(manifest: str, root: str, tok, perturb, workers: int):
    """The recipe's loader: SpeechDataset at 16 kHz, the duration-bucket
    sampler, BatchLoader."""
    from stac_st_tpu_torch.data import (
        BatchLoader,
        DynamicBatchSampler,
        SpeechDataset,
    )

    ds = SpeechDataset(manifest, tok, sample_rate=SR,
                       replacements={"data_root": root},
                       speed_perturb=perturb)
    smp = DynamicBatchSampler(ds.durations(), **LOADER)
    return BatchLoader(ds, smp, sample_rate=SR, num_workers=workers,
                       token_pad_multiple=32)


def loader_rate(loader) -> float:
    """Source audio-s read, resampled and collated per second over one
    epoch of ``loader`` with nothing else running."""
    loader.set_epoch(0)
    t0, audio_s = time.perf_counter(), 0.0
    for batch in loader:
        audio_s += float(np.sum(batch.duration))
    return audio_s / (time.perf_counter() - t0)


def loader_stages(ds, host_perturb, n: int = 24):
    """Host ms per utterance of each stage of a sample, on one thread:
    reading and resampling to 16 kHz, tokenizing, the host perturbation
    at 90% speed, and collating (per row of one batch)."""
    from stac_st_tpu_torch.data import collate_batch, read_audio, wav_paths
    from stac_st_tpu_torch.data.text import build_target_ids

    n = min(n, len(ds))
    acc = {"read_resample": 0.0, "tokenize": 0.0, "host_perturb_90": 0.0}
    samples = []
    for i in range(n):
        entry = ds.entry(i)
        t0 = time.perf_counter()
        sig = np.concatenate([read_audio(p, sample_rate=SR)[0]
                              for p in wav_paths(entry)])
        t1 = time.perf_counter()
        build_target_ids(entry, ds.tokenizer)
        t2 = time.perf_counter()
        host_perturb(sig, 90)
        t3 = time.perf_counter()
        for key, dt in zip(acc, (t1 - t0, t2 - t1, t3 - t2)):
            acc[key] += dt
        samples.append(ds[i])
    t0 = time.perf_counter()
    collate_batch(samples, audio_pad_samples=int(15.5 * SR),
                  token_pad_multiple=32)
    acc["collate"] = time.perf_counter() - t0
    return {k: v / n * 1e3 for k, v in acc.items()}


class Recorder:
    """Passes a BatchLoader through to STTrainer.fit and keeps each epoch's
    batches and the host time at each hand-over."""

    def __init__(self, torch, loader):
        self.torch, self.loader = torch, loader
        self.seen, self.marks, self.epoch = {}, [], None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            self.torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            self.seen.setdefault(self.epoch, []).append(batch)
            yield batch
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter())


def tf32_resample_err(torch, perturb, args, want) -> float:
    """Max abs error, against the fp32 resample ``want``, of the same
    perturbation with the resample's TF32 guard taken out and TF32
    allowed: what the guard prevents."""
    import contextlib

    from stac_st_tpu_torch.ops import speed_perturb as SP

    guard = SP._cudnn_fp32
    SP._cudnn_fp32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    try:
        got, _ = perturb.apply(*(a.cuda() for a in args))
    finally:
        SP._cudnn_fp32 = guard
        torch.backends.cudnn.allow_tf32 = False
    return float((got.cpu() - want).abs().max())


def same_batch(a, b) -> bool:
    return (a.id == b.id and a.extras == b.extras
            and all(np.array_equal(x, y)
                    for name in ("sig", "tokens", "tokens_bos", "tokens_eos")
                    for x, y in zip(getattr(a, name), getattr(b, name))))


def data_train_phase(torch, kernels, profile: bool):
    """STTrainer.fit at the flagship width for two epochs over the port's
    BatchLoader, from 8 kHz files on disk, with DeviceSpeedPerturb."""
    import tempfile

    from stac_st_tpu_torch.ops.speed_perturb import (
        DeviceSpeedPerturb,
        SpeedPerturb,
    )
    from stac_st_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe

    rec = {"phase": "data_train", "utterances": N_CORPUS,
           "file_rate": FILE_SR, "rate": SR, "speeds": list(SPEEDS),
           "loader": LOADER, "dtype": "bfloat16"}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        manifest, lines, corpus_s = write_corpus(root)
        rec["corpus_audio_s"] = corpus_s
        rec["corpus_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = train_bpe(lines, vocab_size=600,
                          user_defined_symbols=["[es]", "[en]", "[turn]",
                                                "[xt]"])
        model.save(os.path.join(root, "bpe.model"))
        tok = SentencePieceProcessor(os.path.join(root, "bpe.model"))
        rec["tokenizer_train_s"] = time.perf_counter() - t0
        rec["tokenizer_vocab"] = tok.get_piece_size()
        check(tok.get_piece_size() >= 500, f"vocab {tok.get_piece_size()}")
        check([tok.piece_to_id(s) for s in ("[es]", "[en]", "[turn]", "[xt]")]
              == [3, 4, 5, 6], "user symbols follow the control pieces")

        def device_perturb():
            p = DeviceSpeedPerturb(orig_freq=SR, speeds=list(SPEEDS))
            p.seed(TRAIN_SEED)
            return p

        def host_perturb():
            p = SpeedPerturb(orig_freq=SR, speeds=list(SPEEDS))
            p.seed(TRAIN_SEED)
            return p

        # the host pipeline alone, no step running, after one untimed
        # epoch (page cache, filter banks); then its stages, one thread
        loader_rate(corpus_loader(manifest, root, tok, device_perturb(), 4))
        rates = {}
        for kind, make in (("device_perturb", device_perturb),
                           ("host_perturb", host_perturb)):
            for workers in (1, 4):
                rates[f"{kind}_workers{workers}"] = loader_rate(corpus_loader(
                    manifest, root, tok, make(), workers))
        rec["loader_audio_s_per_s"] = rates
        rec["loader_stage_ms_per_utt"] = loader_stages(
            corpus_loader(manifest, root, tok, None, 1).dataset,
            host_perturb())

        perturb = device_perturb()
        loader = corpus_loader(manifest, root, tok, perturb, 4)
        trainer = _trainer(torch, flagship(0), bf16=True,
                           speed_perturb=perturb)
        check(trainer.cfg.device_speed is perturb, "device speed configured")
        feeds = Recorder(torch, loader)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses = []
        for epoch in (1, 2):
            trainer.fit([epoch], feeds)
            losses += [float(x) for x in trainer.epoch_losses]
        fit_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        batches = feeds.seen[1] + feeds.seen[2]
        steps = len(batches)
        check(steps == 2 * len(loader) and len(losses) == steps,
              f"{steps} steps, {len(losses)} losses")
        check(all(np.isfinite(losses)), f"losses {losses}")
        check(trainer.state.micro_step == steps, "micro steps")
        for name in FLASH[1:]:
            check(launches.get(name, 0) == 18 * steps,
                  f"{name}: {launches.get(name, 0)} launches, want 18 a step")
            check(launches.get(f"{name}/{TC}", 0) == 18 * steps,
                  f"{name} on the tensor cores: {launches}")
        check(launches.get("flash_attention", 0) == 0, "no eval kernel in fit")
        widths = []
        for b in batches:
            spec = loader.sampler.bucket_of(loader.dataset.ids.index(b.id[0]))
            bucket = int(np.ceil(spec.boundary * SR))
            check(b.sig.data.shape[1] == bucket,
                  f"batch width {b.sig.data.shape[1]}, bucket {bucket}")
            check(len(b.speed_idx) == len(b), "every row has a speed")
            widths.append(bucket)
        draws = [{u: s for b in feeds.seen[e] for u, s in zip(b.id,
                                                                 b.speed_idx)}
                 for e in (1, 2)]
        check(draws[0] != draws[1], "the two epochs draw the same speeds")
        check(set(draws[0].values()) == {0, 1, 2}, "every speed drawn")
        loader.set_epoch(1)
        again = list(loader)
        check(len(again) == len(feeds.seen[1]) and all(
            same_batch(a, b) for a, b in zip(again, feeds.seen[1])),
            "a second pass over epoch 1 differs")

        # the first batch's perturbation, card (with TF32 allowed around
        # it: the resample must turn it off for itself) against the CPU
        first = feeds.seen[1][0]
        args = (torch.from_numpy(first.sig.data),
                torch.from_numpy(first.sig.lengths),
                torch.tensor(first.speed_idx))
        torch.backends.cudnn.allow_tf32 = True
        try:
            sig_c, rel_c = perturb.apply(*(a.cuda() for a in args))
            check(torch.backends.cudnn.allow_tf32, "caller's TF32 restored")
        finally:
            torch.backends.cudnn.allow_tf32 = False
        sig_h, rel_h = perturb.apply(*args)
        perturb_err = float((sig_c.cpu() - sig_h).abs().max())
        # information only: the same resample without its TF32 guard
        rec["perturb_tf32_err"] = tf32_resample_err(torch, perturb, args,
                                                    sig_h)
        check(perturb_err <= RESAMPLE_ATOL,
              f"device resample card vs CPU: err {perturb_err}")
        check(torch.equal(rel_c.cpu(), rel_h), "relative lengths card vs CPU")
        check(sig_c.shape[1] == perturb.out_width(first.sig.data.shape[1]),
              "perturbed width")

        # a warm step on the largest batch, alone
        big = max(batches, key=lambda b: b.sig.data.size)
        dev_batch = trainer._device_batch(big)
        state, times = trainer.state, []
        for _ in range(6):
            seed = trainer.next_seed()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(state, dev_batch, seed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = float(np.median(times[1:]))
        big_s = float(np.sum(big.duration))
        rec.update({
            "steps": steps, "batches_per_epoch": len(loader),
            "rows": [len(b) for b in batches],
            "bucket_widths": widths, "fit_s": fit_s,
            "fit_audio_s_per_s": 2 * corpus_s / fit_s,
            "step_wall_ms": [x * 1e3 for x in np.diff(feeds.marks)],
            "losses": losses, "launches_fit": launches,
            "launches_per_step": {n: launches.get(n, 0) / steps
                                  for n in FLASH[1:]},
            "perturb_card_vs_cpu_err": perturb_err,
            "perturb_atol": RESAMPLE_ATOL,
            "warm_step_batch": len(big), "warm_step_audio_s": big_s,
            "warm_step_width": int(dev_batch["sig"].shape[1]),
            "warm_step_ms": warm * 1e3, "warm_step_ms_all":
                [x * 1e3 for x in times],
            "warm_audio_s_per_s": big_s / warm,
            "peak_memory_gb": peak / 1e9})
        if profile:
            seed = trainer.next_seed()
            t0 = time.perf_counter()
            trainer.train_step(state, dev_batch, seed)
            torch.cuda.synchronize()
            rec["profile"] = profile_call(
                torch, lambda: trainer.train_step(state, dev_batch, seed),
                time.perf_counter() - t0, "data_train_step")
    emit(rec)
    return rec


def _card_vs_cpu_step(torch, pb, speed_idx=None):
    """One train step of batch ``pb`` at full width (2 + 2 layers), fp32,
    dropout 0, on the card and on the CPU; with ``speed_idx``, through
    DeviceSpeedPerturb. Checks and returns the comparison."""
    from stac_st_tpu_torch.ops.fbank import Fbank
    from stac_st_tpu_torch.ops.speed_perturb import DeviceSpeedPerturb
    from stac_st_tpu_torch.training import step as S
    from stac_st_tpu_torch.training.optim import AdamW
    from stac_st_tpu_torch.training.schedulers import WarmCoolDecayLRSchedule

    arrays = {"sig": pb.sig.data, "sig_len": pb.sig.lengths,
              "tokens": pb.tokens.data, "tokens_len": pb.tokens.lengths,
              "tokens_bos": pb.tokens_bos.data,
              "tokens_eos": pb.tokens_eos.data,
              "tokens_eos_len": pb.tokens_eos.lengths}
    if speed_idx is not None:
        arrays["speed_idx"] = np.asarray(speed_idx, np.int64)
    lr = 1e-3
    res = {}
    for dev in ("cuda", "cpu"):
        mods = flagship(2, enc=2, dec=2, dropout=0.0)
        cfg = S.StepConfig(
            fbank=Fbank(), cnn=mods["cnn"], transformer=mods["transformer"],
            seq_lin=mods["seq_lin"], ctc_lin=mods["ctc_lin"],
            specaug_opts=None, ctc_weight=0.3, label_smoothing=0.1,
            loss_reduction="batchmean", pad_index=0, blank_index=0,
            device_speed=(None if speed_idx is None
                          else DeviceSpeedPerturb(speeds=list(SPEEDS))))
        tx = S.make_optimizer(
            AdamW(lr=lr), WarmCoolDecayLRSchedule(lr, 1000, 1000, 100000,
                                                  decay_every=10000).value,
            1, 5.0, 100)
        state = S.init_train_state(cfg, tx, dev)
        batch = {k: torch.from_numpy(v).to(dev).long()
                 if v.dtype in (np.int32, np.int64)
                 else torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        metrics, grad, _ = S.loss_and_grad(cfg, state, batch, 0, True)
        state, _ = S.make_train_step(cfg, tx)(state, batch, 0, True)
        res[dev] = (float(metrics["loss"]), grad.detach().cpu(),
                    state.params.flat.cpu())
        res[f"{dev}_params"] = state.params
    (l_c, g_c, p_c), (l_h, g_h, p_h) = res["cuda"], res["cpu"]
    loss_rel = abs(l_c - l_h) / abs(l_h)
    scale = float(g_h.abs().max())
    # The front end's fbank differs across devices by ~2e-6 relative (its
    # DFT sums in another order); a LeakyReLU unit whose input sits that
    # close to 0 switches slope (1 vs 0.01), so a few terms of the conv
    # gradient sums differ: the CNN's gradients get 1e-3 of the largest
    # gradient, every other parameter 1e-4 (fp32 sums in another order).
    cnn = torch.zeros_like(g_h, dtype=torch.bool)
    for name, view in res["cpu_params"].named(cnn).items():
        if name.startswith("CNN."):
            view.fill_(True)
    gd = (g_c - g_h).abs()
    grad_err = float(gd[~cnn].max()) / scale
    grad_err_cnn = float(gd[cnn].max()) / scale
    # Adam's first update is lr * g/|g| per element: where |g| stands well
    # above the cross-device noise the two must agree to fp32 rounding;
    # elsewhere (e.g. the key-projection bias, whose true gradient is 0)
    # each side's sign is noise and the two differ by at most 2 lr
    sure = g_h.abs() > 1e-3 * scale
    d = (p_c - p_h).abs()
    sure_err, any_err = float(d[sure].max()), float(d.max())
    what = "train" if speed_idx is None else "perturbed train"
    check(loss_rel <= 1e-5, f"{what} loss card vs CPU: rel {loss_rel}")
    check(grad_err <= 1e-4, f"{what} gradients card vs CPU: rel {grad_err}")
    check(grad_err_cnn <= 1e-3, f"{what} CNN gradients card vs CPU: "
          f"{grad_err_cnn}")
    check(sure_err <= 1e-6, f"{what} updated params card vs CPU: {sure_err}")
    check(any_err <= 2 * lr * 1.001, f"{what} updated params bound: {any_err}")
    return {"loss_card": l_c, "loss_cpu": l_h,
            "loss_rel_err": loss_rel, "loss_rtol": 1e-5,
            "grad_rel_err": grad_err, "grad_rtol_of_max": 1e-4,
            "cnn_grad_rel_err": grad_err_cnn, "cnn_grad_rtol_of_max": 1e-3,
            "param_err_determined": sure_err, "param_atol_determined": 1e-6,
            "determined_share": float(sure.float().mean()),
            "param_err_any": any_err, "param_atol_any": 2 * lr}


def card_vs_cpu_train_phase(torch):
    """One train step at full width (2 + 2 layers), fp32, dropout 0, card
    against CPU; then a step of three rows through DeviceSpeedPerturb,
    one row at each speed."""
    rec = {"phase": "card_vs_cpu_train", "batch": 2, "seconds": 2.0,
           "dtype": "float32"}
    rec.update(_card_vs_cpu_step(
        torch, _train_batch(np.random.default_rng(3), 2, 2 * SR, 16)))
    rec["speed_perturbed"] = {"batch": 3, "speeds": list(SPEEDS),
                              **_card_vs_cpu_step(
        torch, _train_batch(np.random.default_rng(4), 3, 2 * SR, 16),
        speed_idx=[0, 1, 2])}
    emit(rec)


def card_vs_cpu_phase(torch):
    """The port on the card against the port on the CPU, fp32, 2 x 2 s."""
    rng = np.random.default_rng(1)
    wavs = [(0.1 * rng.standard_normal(int(2 * SR))).astype(np.float32)
            for _ in range(2)]
    rec = {"phase": "card_vs_cpu", "batch": 2, "seconds": 2.0,
           "dtype": "float32"}
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = engine(flagship(1), dev, bf16=False, beam_size=BEAM,
                     max_decode_tokens=16)
        with torch.inference_mode():
            (_, batch, lens), = eng._prepare(wavs)
            enc = eng._encode(batch, lens)
            model = eng._transformer
            cache = model.init_decode_cache(enc, 4, None, BEAM,
                                            anc_mode=True)
            for p, tok in enumerate(eng._prompt("es", "en")):
                toks = torch.full((2 * BEAM,), tok, dtype=torch.long,
                                  device=enc.device)
                logits = eng.searcher.seq_lin(
                    model.decode_step(toks, p, cache))
            prompt = torch.tensor(eng._prompt("es", "en"))
            tokens, lengths, _ = eng.searcher.search(enc, prompt)
        outs[dev] = (logits.float().cpu(), tokens.cpu(), lengths.cpu())
    err = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
    check(err <= 1e-3, f"card vs CPU decode-step logits: err {err}")
    tok_c, len_c = outs["cuda"][1], outs["cuda"][2]
    tok_h, len_h = outs["cpu"][1], outs["cpu"][2]
    steps = min(tok_c.shape[1], tok_h.shape[1])
    same = (tok_c[:, :steps] == tok_h[:, :steps]).float().mean().item()
    rec.update({"logits_max_abs_err": err, "logits_atol": 1e-3,
                "translate_token_agreement": same,
                "lengths_equal": bool(torch.equal(len_c, len_h))})
    emit(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm translate call with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from stac_st_tpu_torch.device import set_tf32
    from stac_st_tpu_torch.ops import kernels
    from stac_st_tpu_torch.ops.kernels import decode_attention as K

    set_tf32(False)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = kernels.build(["decode_attention", "train_attention"])
    build_s = time.perf_counter() - t0
    K._lib()
    from stac_st_tpu_torch.ops.kernels import attention as A
    from stac_st_tpu_torch.ops.kernels import train_attention as TA

    TA.lib()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write("\n".join(kernels.build_logs.values()))
    ptxas = [ln.strip() for log in kernels.build_logs.values()
             for ln in log.splitlines() if "registers" in ln
             or "wgmma" in ln]
    tc_spills, split_regs = {}, {}
    for lib_name, kerns in (("train_attention", TC_KERNELS),
                            ("decode_attention", SPLIT_KERNELS)):
        for kern, n in kerns.items():
            found = spills(kernels.build_logs[lib_name], kern)
            check(len(found) == n and not any(sum(v) for v in found.values()),
                  f"{kern} spills: {found}")
            tc_spills.update(found)
            if lib_name == "decode_attention":
                split_regs.update(registers(kernels.build_logs[lib_name],
                                            kern))
    emit({"phase": "environment", "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "kernel_build_s": build_s, "built": built, "ptxas": ptxas,
          "tc_kernel_spills": tc_spills, "split_kernel_registers": split_regs})

    timer = Timer(torch)
    rows = kernel_phase(torch, K, timer)
    train_rows = train_kernel_phase(torch, kernels, timer)
    main_rec = main_path_phase(torch, kernels, args.profile)
    _, train_launches = train_phase(torch, kernels, args.profile)
    data_train_phase(torch, kernels, args.profile)
    card_vs_cpu_phase(torch)
    card_vs_cpu_train_phase(torch)

    kernel_line = []
    for rec in rows:
        bf = rec["bfloat16"]
        replaces, source = K.KERNELS[rec["name"]]
        kernel_line.append({
            "name": rec["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": main_rec["launches"].get(rec["name"], 0),
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
        })
        if rec["name"] in DECODE_SPLIT:
            kernel_line[-1]["variant"] = "/".join(
                v for v in (SPLIT, "simt")
                if main_rec["launches"].get(f"{rec['name']}/{v}"))
    flash_kernels = {**A.KERNELS, **TA.KERNELS}
    for rec in train_rows:
        enc = rec["encoder_self"]  # the shape of 12 of the 18 launches
        replaces, source = flash_kernels[rec["name"]]
        kernel_line.append({
            "name": rec["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": train_launches.get(rec["name"], 0),
            "max_abs_err": max(v for k, v in rec["abs_err"].items()
                               if "bfloat16" in k),
            "ms": enc["ms"], "plain_ms": enc["plain_ms"],
            "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
            "library_ms": enc["library_ms"],
            "variant": "/".join(v for v in VARIANTS
                                if train_launches.get(f"{rec['name']}/{v}")),
        })
    print(smi, flush=True)
    emit({"kernels": kernel_line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
