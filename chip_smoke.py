#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stac_st_tpu_torch) on one GPU, end to end.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py             # the check
    python3 chip_smoke.py --profile   # also trace one warm translate call

Phases, each printed as one JSON line:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions, and the build time of the kernels (nvcc, sm_90a, from
   stac_st_tpu_torch/csrc into build/torch_kernels/);
2. kernel: each decode-attention kernel against its plain PyTorch version
   at the serving path's shapes (B 16 x 10 s, beam 10: 160 rows, 4 heads of
   64, self cache 3 + 192 positions, 251 encoder frames), in fp32 with TF32
   off and in bf16, with the times of the kernel, the plain version, one
   library call computing the same function (timed here only; the port
   never calls it) and the least time the card could take;
3. main_path: the engine at the flagship width (d256, 4 heads, 12 + 6
   layers, FFN 1024, vocab 5000, CNN (256, 256); bf16, seeded random
   weights) serving B 16 x 10 s of PCM16 through translate,
   transcribe_and_translate and speaker_turns, plus one short beam-1 call;
   the kernels' launch counts are zeroed just before and read just after;
4. card_vs_cpu: the port on the card against the port on the CPU, full
   width, fp32, 2 x 2 s: one decode step's logits and the token agreement
   of a short translate.

Then the card's name and power limit, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result. It needs the rest of the repository;
alone, or without a CUDA device, it fails.
"""

from __future__ import annotations

import argparse
import json
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


class SyntheticTokenizer:
    """Duck-typed tokenizer for seeded random weights: language tags map
    to fixed ids, every other id to a word of its own."""

    LANGS = {"[es]": 3, "[en]": 4}

    def encode_as_ids(self, text):
        return [self.LANGS[text]]

    def decode_ids(self, ids):
        return " ".join(f"w{i}" for i in ids)


def flagship(seed: int):
    """The flagship preset's modules with seeded Glorot weights (CPU)."""
    import torch

    from stac_st_tpu_torch.models import (
        ConvolutionFrontEnd,
        LinearHead,
        TransformerMultiTask,
        glorot_init_,
    )

    mods = dict(
        transformer=TransformerMultiTask(
            5000, 5120, d_model=256, nhead=4, num_encoder_layers=12,
            num_decoder_layers=6, d_ffn=1024),
        cnn=ConvolutionFrontEnd(out_channels=(256, 256)),
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
        rec["profile"] = profile_translate(torch, eng, wavs, t6 - t5)
    emit(rec)
    return rec


def profile_translate(torch, eng, wavs, wall_unprofiled: float):
    """Device time by kernel over one warm translate call (the union of
    kernel and copy intervals is the busy time; the idle share is taken
    against the same call's wall time without the profiler). The table
    goes to chiprun_out/profile_translate.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.translate(wavs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_translate.txt"), "w") as f:
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
    built = kernels.build(["decode_attention"])
    build_s = time.perf_counter() - t0
    K._lib()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write("\n".join(kernels.build_logs.values()))
    ptxas = [ln.strip() for log in kernels.build_logs.values()
             for ln in log.splitlines() if "registers" in ln]
    emit({"phase": "environment", "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count(),
          "kernel_build_s": build_s, "built": sorted(built),
          "ptxas": ptxas})

    timer = Timer(torch)
    rows = kernel_phase(torch, K, timer)
    main_rec = main_path_phase(torch, kernels, args.profile)
    card_vs_cpu_phase(torch)

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
    print(smi, flush=True)
    emit({"kernels": kernel_line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
