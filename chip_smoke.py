#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stac_st_tpu_torch) on one GPU, end to end.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py             # the check
    python3 chip_smoke.py --profile   # also trace one warm translate call
                                      # and one warm train step

Phases, each printed as one JSON line:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions, and the build time of the kernels (nvcc, sm_90a, every
   source of stac_st_tpu_torch/csrc built in parallel into
   build/torch_kernels/); ptxas must report no spills for the
   tensor-core kernels (fwd_tc_kernel, four instantiations; dq_tc_kernel
   and dkv_tc_kernel, two each);
2. kernel: each decode-attention kernel against its plain PyTorch version
   at the serving path's shapes (B 16 x 10 s, beam 10: 160 rows, 4 heads of
   64, self cache 3 + 192 positions, 251 encoder frames), in fp32 with TF32
   off and in bf16, with the times of the kernel, the plain version, one
   library call computing the same function (timed here only; the port
   never calls it) and the least time the card could take;
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
   the kernels' launch counts are zeroed just before and read just after;
5. train: the flagship training configuration as bench_train.py builds it
   (dropout 0.1, CTC 0.3, label smoothing 0.1, batchmean, AdamW 1e-3,
   WarmCoolDecay, clip 5.0, bf16 compute, B32 x 15 s, U128, seeded
   weights) through STTrainer.fit for one epoch of 6 copies of one batch,
   CMVN update on; counts zeroed just before and read just after (exactly
   18 training-forward, 18 dQ and 18 dK/dV launches a step, every one on
   a tensor-core kernel), then one eval forward (exactly 18
   flash_attention launches, all on the tensor-core kernel);
6. card_vs_cpu: the port on the card against the port on the CPU, full
   width, fp32, 2 x 2 s: one decode step's logits and the token agreement
   of a short translate;
7. card_vs_cpu_train: one train step, full width d256/H4, 2 + 2 layers,
   B2 x 2 s, fp32 (TF32 off), dropout 0: loss, gradients and updated
   parameters, card against CPU.

Then the card's name and power limit, a {"kernels": [...]} line (the four
flash kernels name the variant their main-path launches went through),
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

    def ms(self, fn, n: int = 30) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(n):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


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


def kernel_phase(torch, K, timer):
    """Each kernel vs its plain version at the serving shapes."""
    import torch.nn.functional as F

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
                lib = partial(F.scaled_dot_product_attention, q[:, :, None],
                              k[..., :n].transpose(-1, -2), v[:, :, :n],
                              scale=1.0)
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
                lib = partial(F.scaled_dot_product_attention,
                              q.reshape(B, BEAM, H, DH).transpose(1, 2),
                              k.transpose(-1, -2), v, scale=1.0)
                nbytes = (2 * BB * H * DH + 2 * B * H * S_ENC * DH) * es
                flops = 4.0 * BB * H * S_ENC * DH
                # the padding-bias variant is checked too (not timed)
                bias = torch.where(
                    torch.arange(S_ENC, device="cuda")[None, :]
                    < torch.tensor([S_ENC, 200, 31] * 5 + [100],
                                   device="cuda")[:, None], 0.0, -1e9)
                err_b = (K.decode_cross_attention(q, k, v, bias, BEAM).float()
                         - K.decode_cross_attention_ref(q, k, v, bias, BEAM)
                         .float()).abs().max().item()
                check(err_b <= TOL[dtype],
                      f"{name} {dtype} with bias: err {err_b}")
            out = run()
            torch.cuda.synchronize()
            err = (out.float() - plain().float()).abs().max().item()
            check(bool(torch.isfinite(out).all()), f"{name} {dtype} finite")
            check(err <= TOL[dtype],
                  f"{name} {dtype}: max abs err {err} > {TOL[dtype]}")
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            rec[dtype] = {
                "max_abs_err": err, "tol": TOL[dtype],
                "ms": timer.ms(run), "plain_ms": timer.ms(plain),
                "library_ms": None if lib is None else timer.ms(lib),
                "bound_ms": b_ms, "bound_by": b_by,
            }
        emit(rec)
        rows.append(rec)
    return rows


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


def main_path_phase(torch, kernels, profile: bool):
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(int(SECONDS * SR)) * 3000)
            .clip(-32768, 32767).astype(np.int16) for _ in range(B)]
    audio_s = B * SECONDS
    mods = flagship(0)
    eng = engine(mods, "cuda", bf16=True, beam_size=BEAM,
                 max_decode_tokens=192, transfer_dtype="int16")
    eng1 = engine(mods, "cuda", bf16=True, beam_size=1,
                  max_decode_tokens=192, transfer_dtype="int16")
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
    for name in ("decode_self_attention", "decode_self_attention_anc",
                 "decode_cross_attention"):
        check(launches.get(name, 0) > 0, f"{name} launched on the main path")
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
        rec["profile"] = profile_call(torch, lambda: eng.translate(wavs),
                                      t6 - t5, "translate")
    emit(rec)
    return rec


def profile_call(torch, fn, wall_unprofiled: float, name: str):
    """Device time by kernel over one call of ``fn`` (the union of kernel
    and copy intervals is the busy time; the idle share is taken against
    the same call's wall time without the profiler). The table goes to
    chiprun_out/profile_<name>.txt."""
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
    spans, by_name = [], {}
    for ev in prof.events():
        # device work only; CUPTI's own buffer requests are not the program's
        if ev.device_type != DeviceType.CUDA or \
                ev.name.startswith("Activity Buffer"):
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us()
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_profiled_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_unprofiled,
            "top_device_us": [[k[:60], v] for k, v in top]}


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


def _trainer(torch, mods, bf16: bool):
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
        use_grad_clipping=True, max_grad_norm=5.0)
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


def card_vs_cpu_train_phase(torch):
    """One train step at full width (2 + 2 layers), fp32, dropout 0, card
    against CPU."""
    from stac_st_tpu_torch.ops.fbank import Fbank
    from stac_st_tpu_torch.training import step as S
    from stac_st_tpu_torch.training.optim import AdamW
    from stac_st_tpu_torch.training.schedulers import WarmCoolDecayLRSchedule

    rng = np.random.default_rng(3)
    pb = _train_batch(rng, 2, 2 * SR, 16)
    arrays = {"sig": pb.sig.data, "sig_len": pb.sig.lengths,
              "tokens": pb.tokens.data, "tokens_len": pb.tokens.lengths,
              "tokens_bos": pb.tokens_bos.data,
              "tokens_eos": pb.tokens_eos.data,
              "tokens_eos_len": pb.tokens_eos.lengths}
    lr = 1e-3
    res = {}
    for dev in ("cuda", "cpu"):
        mods = flagship(2, enc=2, dec=2, dropout=0.0)
        cfg = S.StepConfig(
            fbank=Fbank(), cnn=mods["cnn"], transformer=mods["transformer"],
            seq_lin=mods["seq_lin"], ctc_lin=mods["ctc_lin"],
            specaug_opts=None, ctc_weight=0.3, label_smoothing=0.1,
            loss_reduction="batchmean", pad_index=0, blank_index=0)
        tx = S.make_optimizer(
            AdamW(lr=lr), WarmCoolDecayLRSchedule(lr, 1000, 1000, 100000,
                                                  decay_every=10000).value,
            1, 5.0, 100)
        state = S.init_train_state(cfg, tx, dev)
        batch = {k: torch.from_numpy(v).to(dev).long() if v.dtype == np.int32
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
    check(loss_rel <= 1e-5, f"train loss card vs CPU: rel {loss_rel}")
    check(grad_err <= 1e-4, f"gradients card vs CPU: rel {grad_err}")
    check(grad_err_cnn <= 1e-3, f"CNN gradients card vs CPU: {grad_err_cnn}")
    check(sure_err <= 1e-6, f"updated params card vs CPU: {sure_err}")
    check(any_err <= 2 * lr * 1.001, f"updated params bound: {any_err}")
    emit({"phase": "card_vs_cpu_train", "batch": 2, "seconds": 2.0,
          "dtype": "float32", "loss_card": l_c, "loss_cpu": l_h,
          "loss_rel_err": loss_rel, "loss_rtol": 1e-5,
          "grad_rel_err": grad_err, "grad_rtol_of_max": 1e-4,
          "cnn_grad_rel_err": grad_err_cnn, "cnn_grad_rtol_of_max": 1e-3,
          "param_err_determined": sure_err, "param_atol_determined": 1e-6,
          "determined_share": float(sure.float().mean()),
          "param_err_any": any_err, "param_atol_any": 2 * lr})


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
    tc_spills = {}
    for kern, n in TC_KERNELS.items():
        found = spills(kernels.build_logs["train_attention"], kern)
        check(len(found) == n and not any(sum(v) for v in found.values()),
              f"{kern} spills: {found}")
        tc_spills.update(found)
    emit({"phase": "environment", "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "kernel_build_s": build_s, "built": built, "ptxas": ptxas,
          "tc_kernel_spills": tc_spills})

    timer = Timer(torch)
    rows = kernel_phase(torch, K, timer)
    train_rows = train_kernel_phase(torch, kernels, timer)
    main_rec = main_path_phase(torch, kernels, args.profile)
    _, train_launches = train_phase(torch, kernels, args.profile)
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
