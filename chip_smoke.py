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
   (self_split_kernel and its ragged form self_split_rows_kernel,
   cross_split_kernel, anc_split_kernel, and the int8 cache's
   self_i8_split_kernel, self_i8_split_rows_kernel and
   cross_i8_split_kernel, two instantiations each), whose registers are
   reported;
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
   search's B32); and self's ragged form (one index per row, as the
   continuous slot loop steps it): 16 slots of the 195-position cache at
   indices 3 to 194 and one past the cache, fp32 (``simt``) and bf16
   (``split``, bitwise over two launches), counted under
   ``decode_self_attention/rows``, its SDPA yardstick with the
   equivalent key mask; and cross at the slot loop's shapes: 16 slots
   padded to 801 encoder frames, each masked past floor(len · S_w) of its
   own 2-32 s bucket, at beam 1 (the chunk step) and beam 3 (prompt
   priming of a full rung), fp32 and bf16 (bitwise over two launches),
   timed with its bound and the SDPA yardstick with the same mask; and
   the int8 cache's two kernels (decode_self_attention_int8, its ragged
   form counted under .../rows, decode_cross_attention_int8) against their
   plain versions, fp32 (``simt``) and bf16 (``split``, ptxas: no
   spills), bitwise over two launches, at self 160 rows x 195 and 16 rows
   idx 194, the ragged form at the 16 slots above, cross at B16 x beam 10
   x 251 and at the slot loop's 16 x 801 with the per-slot bias, each
   beside the float kernel on the dequantized values (no library call
   takes int8 K/V with scales);
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
4b. int8: main_path's translate with the int8 KV cache (the searcher's
   gather mode), with int8 weights, and with both: warm RTFx beside
   main_path's, exact launch counts of the warm call (1170 int8 self and
   1170 int8 cross, all on split, or 1170 anc and 1170 cross on split),
   token agreement with bf16 (printed), main_path's beam-1 call with the
   int8 cache (1170 scalar int8 self and 1170 int8 cross on split; its
   texts against the bf16 beam-1 call's printed), one decoder step's
   weight products bf16 against int8, and an fp32 engine with each
   option, card against CPU (one decode step's logits; --profile traces
   the int8 cache's call);
4c. speculative: SpeculativeSTEngine (flagship target, d256 2 + 2-layer
   draft, k = 6, 64 tokens) on four utterances of 2-10 s: fp32 texts equal
   to the target's beam-1 decode with float and with int8 caches, bf16
   agreement printed, tokens per target step and RTFx;
4d. search_options: the searcher's options at the flagship preset (seeded
   weights, bf16, main_path's search: beam 10, eos threshold 1.5, length
   normalization, temperature 1.15, 192 tokens) in a 10 s bucket (251
   encoder frames). The CTC prefix kernel (ctc_prefix_score,
   csrc/ctc_prefix.cu, ctc_prefix_kernel v3: a warp scan a lane) against
   its plain version: 160 rows (B16 x beam 10), 11 candidates, 251
   frames, vocab 5000, half the rows mid-prefix, lengths 126-251, eos,
   blank and the last label among the candidates, then the full
   vocabulary at B2 x beam 1, then 4,200 frames at B2 x beam 3, K 4
   (beyond the earlier designs' cap of 4,096): within 1e-4 of
   max(1, |plain|), the -1e9 class in the same places, bitwise over two
   launches, every call launched and counted, its µs, bound, plain µs,
   ptxas registers (no spills); the two cross kernels with the mask's
   padding bias at B16 x beam 10 x 251 against their plain versions. Then joint CTC/attention decoding (ctc_weight 0.3, the
   model's CTC head) of main_path's batch with the float cache (anc), via
   call_multi with both prompts, and with the int8 cache (gather): exactly
   one ctc_prefix_score launch a decode step and 6 x (3 + steps) of each
   decode kernel, all split, warm RTFx beside the attention-only search
   (--profile: the device busy time and the CTC kernel's share);
   mask_encoder_padding on 16 utterances of 2-10 s (float and int8 caches:
   every cross call carries the bias, counts exact); LM fusion with a
   seeded stateful LM written here (weight 0 gives the LM-free texts; 0.3
   timed, counts exact); decode_tier 32 under the 192-token cap on the
   flagship weights and on an eos-biased copy (texts equal to the single
   pass; the biased searches take the fast path); each option in fp32 card
   against CPU (B2 x 4 s and 2.5 s, 24 tokens: tokens equal); and the
   speculative engine with the target's padding mask (fp32 texts equal to
   the target's masked beam-1 translate);
5. train: the flagship training configuration as bench_train.py builds it
   (dropout 0.1, CTC 0.3, label smoothing 0.1, batchmean, AdamW 1e-3,
   WarmCoolDecay, clip 5.0, bf16 compute, B32 x 15 s, U128, seeded
   weights) through STTrainer.fit for one epoch of 6 copies of one batch,
   CMVN update on; counts zeroed just before and read just after (exactly
   18 training-forward, 18 dQ and 18 dK/dV launches a step, every one on
   a tensor-core kernel), then one eval forward (exactly 18
   flash_attention launches, all on the tensor-core kernel); then the
   same cell with train_attn_kernel=off (the model's matmul + softmax
   attention, dropout on the weights): a warm step's ms and peak memory
   beside a warm kernel step's, measured the same way, and no launch of
   the four flash kernels in that step or its eval forward;
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
7. recipe: the canonical recipe as a user runs it,
   stac_st_tpu_torch.recipes.train_multitask.main on
   recipes/hparams/transformer_multitask.yaml at its full width (host
   SpeedPerturb, SpecAugment, accumulation 16, bf16), overriding only the
   data and output paths, the splits, 2 epochs, validation search every
   epoch, 4 loader workers, evaluation on, a 10-step warm-up and the
   tokenizer's [turn]/[xt] ids. The data_train corpus, 544 utterances,
   split into train (512), dev (16 ST rows) and a heldout split as ASR
   and as 4-reference ST manifests. The first run gets a SIGTERM raised
   in-process after its third batch: it must save a preempted checkpoint,
   return from fit without validating, chain to and restore the previous
   handler. The second run must resume from that checkpoint with
   parameters, Adam's moments and accumulator, the optimizer's counts,
   the step-seed generator, CMVN and counters bitwise equal to the saved
   ones, re-enter epoch 1, read the batches run 1 trained again without
   training them (so its micro steps are an uninterrupted run's, one for
   each batch of two epochs), train the rest of epoch 1 and epoch 2,
   validate both with the dual search (every decode launch on the fp32
   "simt" kernels, as the JAX trainer searches its fp32 weights), keep 2
   ACC checkpoints, evaluate on their average (bitwise) and write the
   bleu_/wer_ files of both heldout splits; the YAML's references must share the modules. Then
   STEngine.from_saved_experiment loads weights bitwise equal to that
   average and translates the heldout audio. Launches of the phase by
   kernel and variant (kernels 2-7 each at least once), each stage's wall
   seconds, fit's audio-s/s, the validation stats and search seconds
   a epoch; the recipe's own output goes to
   chiprun_out/recipe_log_cuda.txt;
8. card_vs_cpu: the port on the card against the port on the CPU, full
   width, fp32, 2 x 2 s: one decode step's logits, and the token agreement
   and lengths of a short search, attention-only and joint CTC/attention
   (ctc_weight 0.3: the CTC kernel on the card);
9. card_vs_cpu_train: one train step, full width d256/H4, 2 + 2 layers,
   B2 x 2 s, fp32 (TF32 off), dropout 0: loss, gradients and updated
   parameters, card against CPU; then the same for B3 x 2 s through
   DeviceSpeedPerturb, one row at each speed;
10. serve, run right after recipe on the experiment it saved: the batch
   front as ``stac_st_tpu_torch.recipes.serve`` builds it (start_servers:
   HTTP, bf16, --max-batch 16, --pad-batch 4,16, warm-up on); one client
   posts to every route (translate, transcribe, transcribe_translate,
   speaker_turns, long_form on a conversation of at least 60 s made of
   corpus utterances between pauses, /healthz, /stats), each answer equal
   to the engine's direct call; then 16 concurrent clients post
   PCM16-base64 /v1/translate requests of 2-16 s for 20 s, every one
   answered. Then a ContinuousBatchingEngine (16 slots, chunk 16) on the
   same engine behind STHttpServer: 8 requests one at a time against a
   sequential greedy oracle (one row, the scalar self kernel; the bf16
   agreement is printed, not checked), the same concurrent load, and
   protocol_finalize on 6 requests closed right after submitting (every
   future resolves to its final). Then an fp32 engine of the experiment
   (TF32 off): the same 8 requests must give the oracle's tokens exactly;
   and an fp32 engine with the int8 cache: its slot loop (ragged int8
   self, int8 cross, on simt) token-equal to the int8 oracle on the 8
   requests, then 10 s of the same load; then the bf16 slot loop with the
   int8 cache as ``recipes.serve --continuous --kv-cache-dtype int8``
   builds it, 5 s of the same load (ragged int8 self and int8 cross on
   split), its RTFx and utilization beside the float cache's. Launches of the phase (zeroed before): ragged self on ``split`` and
   cross in the slot loop, anc and cross in the batch front, no plain
   version called on a CUDA tensor. Prints sustained RTFx through HTTP
   per front, p50 / p95 / p99 latency, the formed-batch histogram, slot
   utilization, launches by kernel and variant, the phase's seconds, and
   where each load window's time went (seconds and calls of the batch
   front's engine calls and searches, of the slot loop's admissions and
   chunks); --profile also traces 5 s of each front under the same load
   (device busy time and idle share, the decode kernels' µs a launch);
11. encoders, run after serve: the JAX package's other model settings at
   the flagship width and depth, each from seed 0 — (a) a post-LN
   Transformer, (b) a Conformer with RelPosMHAXL, (c) a causal Conformer
   with regular attention (kernel 31, the canonical front end). For each,
   one line: B16 x 10 s through STEngine (bf16, beam 10, 192 tokens):
   anc and cross exactly 6 x the search's decoder steps (counted by
   wrapping decode_step), all split, warm RTFx, the encoder pass's share
   of the translate's device busy time (two traces of the device alone);
   for (a) also a beam-1 translate (self and cross 6 x its steps, split),
   a 16-slot slot loop under 5 s of requests (ragged self 6 x its ragged
   steps, cross 6 x its ragged steps and prompt windows, split) and a
   translate with the int8 cache and int8 weights (int8 self and cross 6
   x its steps, split); 3 steps of B32 x 15 s through STTrainer.fit
   (bf16, dropout 0.1): finite losses, 18 launches a step of each
   training flash kernel (6 for RelPosMHAXL, whose encoder attention is
   plain PyTorch), all wgmma, peak memory; for (b) loss_and_grad with
   remat against without, gradients bitwise equal (CTC weight 0 and
   cuDNN's deterministic algorithms, two runs without remat bitwise equal
   too), with both peaks; card against CPU in fp32 (seed 1, B2 x 4 s and
   2.5 s, 24 tokens): encoder outputs within 1e-3, tokens equal. For (b)
   also the recipe's main on phase recipe's corpus with
   --encoder_module=conformer --attention_type=RelPosMHAXL (the dev split,
   batches of at most 60 s, one epoch, no search, no evaluation), then
   STEngine.from_saved_experiment bitwise equal to the average of its
   kept checkpoints, translating 4 heldout utterances;
12. data_parallel, run after encoders: the trainer and the engine over
   two ranks or shards — nccl with a card each where the machine has two
   cards, else gloo with both ranks on cuda:0 (nccl refuses two ranks on
   one card); the line names the backend and the cards. First the
   training flash kernels on the second half of a B4 x 376 batch with
   row0 = 2 against the whole batch's launch, bf16 (wgmma) and fp32
   (simt), dropout 0.1: bitwise (the dropout hash keys global rows).
   Then, at the flagship width and depth on the B32 x 15 s global batch
   (dropout 0.1, CTC 0.3): two fp32 steps on this process (one rank)
   and on two ranks spawned from here, each shipping its 16 rows: loss,
   reduced gradient and updated parameters within card_vs_cpu_train's
   tolerances of the one-rank run, both ranks one state; six bf16 steps
   through fit at one and at two ranks (each step's ms, the global
   batch's audio-s/s, 18 launches a step of each training flash kernel on
   every rank, all wgmma), the flat gradient's all-reduce (CUDA events and
   wall); then on the two ranks the recipe at its full width on phase
   recipe's dev split (batches of at most 60 s, CTC weight 0 and cuDNN's
   deterministic algorithms, two epochs, the dual search in epoch 2)
   three times: uninterrupted, with SIGTERM raised on rank 1 alone as
   its first step begins (both ranks stop, preempted, after step 2), and
   resumed: parameters bitwise and the final ACC checkpoint's trees equal
   to the uninterrupted run's, the same validation stats. Serving:
   STEngine over a mesh of the two cards (or two shards on cuda:0),
   B16 x 10 s, beam 10: fp32 texts equal to one device's; an fp32 slot
   loop of 16 slots over the mesh (8 requests of 1.5-5 s one at a time,
   going round the shards) token-equal to the sequential greedy oracle;
   bf16 launches of the meshed translate equal to one
   device's over each shard's rows (anc and cross on split), the texts'
   agreement, and warm RTFx at one device and on the mesh;
13. protocol, run after data_parallel: the flagship quality run as
   stac_st_tpu_torch.tools.flagship_run drives it, cut to the script's
   budget. The learnable synthetic corpus (tools.flagship_corpus: 2,000
   training utterances of about 4.5 s, 32 dev, 32 held-out, 2
   conversations of 8; the BPE vocabulary 5000 or the largest the
   trainer reaches, reported); the shipped
   recipes/hparams/transformer_synth_flagship.yaml (d256, 4 heads of 64,
   12 + 6 layers, FFN 1024, CNN (256, 256), bf16) through
   recipes.train_multitask.main with its schedule's step limit, warm-up
   and cool-down cut in proportion (PROTOCOL_STEPS of 4,000) and a wall
   cap on fit (a SIGTERM: the kept ACC checkpoints load); then
   tools.eval_flagship on the experiment: held-out BLEU (ST) and WER
   (ASR) for beam 10, continuous greedy and the hybrid with each
   engine's RTFx, the beam-10 pass's decoder steps per search against
   its 192-token budget, the long-form grid cut to two of its four
   points (pause and shas 6-12), speaker-change F1, precision and recall
   at each tolerance; and
   the trained experiment's warm translate of B16 x 10 s (held-out audio
   padded to 10 s). Checks: training launched the four flash kernels, the
   protocol the ragged self, anc and cross kernels, every number finite.
   Each stage's seconds and launches by kernel and variant (stage lines
   in chiprun_out/protocol_stages.jsonl, the recipe's output in
   chiprun_out/protocol_train_log.txt). No bound on quality;
14. reference_io, run after protocol: the reference's own data and
   checkpoints. (b) A seeded raw Fisher/CALLHOME tree in the LDC layouts
   (stac_st_tpu_torch/examples/ldc_tree.py: 8 conversations of each
   corpus, 3 min each, two-channel 8 kHz mu-law SPHERE, overlapping
   turns) through the port's prepare_fisher_turns and
   prepare_callhome_turns at 30 s and the driver's training mixture:
   windows, [turn] and [xt] counts (both must occur), audio seconds and
   the seconds each took. (a) The native library (csrc/stacnative.cpp,
   g++) built into an empty folder (seconds), its PCM16 decoder on the
   prepared wavs, its mu-law decoder on the SPHERE files and its BPE
   encoder on the manifests' texts, each against the numpy / pure-Python
   version (ms an item, bitwise equal ids and samples), and the loader's
   audio-s/s over the mixture at 1 and 4 workers: findings, not claims.
   (c) STTrainer.fit of the flagship (bf16, seeded) over the mixture for
   20 updates: finite losses, 18 launches a step of each training flash
   kernel, all wgmma. (d) The trained modules exported to the SpeechBrain
   layout (model.ckpt, normalizer.ckpt), imported back with
   tools.import_sb_ckpt (save_imported's checkpoint) and loaded with
   STEngine.from_experiment: parameters and normalizer bitwise the
   trained ones, an fp32 B2 x 4 s beam-10 search's texts equal to an
   engine on the trained modules', then a warm bf16 B16 x 10 s beam-10
   translate (anc and cross exactly 6 x its decoder steps, split) and a
   beam-1 translate of 2 x 10 s (self and cross likewise), each with its
   RTFx.

Then the card's name and power limit, a {"kernels": [...]} line (every
kernel names the variant its main-path launches went through, and its
launches in the recipe, serve, protocol and reference_io phases; the ragged self forms
are lines of their own, their launches the serve phase's; the int8
kernels' launches are phase int8's; ctc_prefix_score's those of phase
search_options' joint CTC search with the float cache),
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
import tempfile
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


def sdpa_yardstick(torch, timer, q, k, v, want, mask=None):
    """The library time of one attention call: scaled_dot_product_attention
    of q (..., Lq, Dh) against k, v (..., n, Dh), at scale 1 (with the
    boolean ``mask`` of visible keys, if given), all three laid out
    contiguous as its fused backends take them (built by the caller,
    outside the timed call). Every fused backend that accepts the call is
    checked against ``want`` (the plain version's output in SDPA's layout;
    within bf16's step, since a backend may compute in bf16) and timed; the
    fastest is kept, with its name. The math path is timed only where no
    fused backend accepts the call."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    call = partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask,
                   scale=1.0)
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


def _rows_lib(q, kT, v, idx, want):
    """SDPA's inputs for the ragged self form: every row's whole cache and
    a mask of the positions 0..min(idx[r], S - 1) it sees."""
    import torch

    S = kT.shape[-1]
    pos = torch.arange(S, device=kT.device)
    mask = pos[None, :] <= idx.clamp(max=S - 1)[:, None]
    return (q[:, :, None], kT.transpose(-1, -2).contiguous(), v,
            want[:, :, None], mask[:, None, None, :])


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
    # the continuous slot loop's shapes, from a generator of their own so
    # the cases above see the same inputs as before them
    g_slots = torch.Generator(device="cpu").manual_seed(1)
    ragged = _self_rows(torch, K, timer, g_slots)
    _cross_slots(torch, K, timer, g_slots)
    return rows + [ragged] + int8_kernel_cases(torch, K, timer)


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


# the ragged self form as continuous serving gives it: 16 slots of a
# 3 + 192-position cache, each at its own index (3 just after the prompt,
# mid-decode, 194 the last position, 200 a finished slot past the cache)
ROWS_IDX = (3, 15, 28, 40, 53, 66, 79, 97, 110, 123, 136, 149, 162, 175, 194,
            200)


def _self_rows(torch, K, timer, g):
    """decode_self_attention's ragged form (one index per row) against its
    plain version, fp32 (TF32 off, ``simt``) and bf16 (``split``, bitwise
    over two launches), with its times and bound; one line of phase
    kernel."""
    from stac_st_tpu_torch.ops import kernels

    name = "decode_self_attention"
    R, S = len(ROWS_IDX), S_SELF
    base = [torch.randn(shape, generator=g) * sc
            for shape, sc in (((R, H, DH), 1 / 8), ((R, H, DH, S), 1),
                              ((R, H, S, DH), 1))]
    idx = torch.tensor(ROWS_IDX, dtype=torch.int32, device="cuda")
    n = [min(i, S - 1) + 1 for i in ROWS_IDX]
    rec = {"phase": "kernel", "name": f"{name}/rows", "rows": R, "S": S,
           "idx": list(ROWS_IDX)}
    for dtype in ("float32", "bfloat16"):
        q, kT, v = (t.to("cuda", getattr(torch, dtype)).contiguous()
                    for t in base)
        run = partial(K.decode_self_attention, q, kT, v, idx)
        plain = partial(K.decode_self_attention_ref, q, kT, v, idx)
        variant = SPLIT if dtype == "bfloat16" else "simt"
        before = dict(kernels.launches)
        out = run()
        torch.cuda.synchronize()
        added = {k: c - before.get(k, 0) for k, c in kernels.launches.items()
                 if c != before.get(k, 0)}
        check(added == {name: 1, f"{name}/{variant}": 1, f"{name}/rows": 1,
                        f"{name}/rows/{variant}": 1},
              f"ragged self {dtype}: launched {added}")
        want = plain()
        err = (out.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"ragged self {dtype} finite")
        check(err <= TOL[dtype], f"ragged self {dtype}: max abs err {err}")
        if dtype == "bfloat16":
            check(torch.equal(out, run()), "ragged self not repeatable")
            rec["bitwise_repeatable"] = True
        es = q.element_size()
        b_ms, b_by = bound_ms(
            (2 * R * H * DH + 2 * H * sum(n) * DH) * es + 4 * R,
            4.0 * H * sum(n) * DH, dtype)
        rec[dtype] = {
            "max_abs_err": err, "tol": TOL[dtype], "variant": variant,
            "ms": timer.ms(run), "plain_ms": timer.ms(plain),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "host_us": host_us(torch, run)}
        rec[dtype].update(sdpa_yardstick(torch, timer,
                                         *_rows_lib(q, kT, v, idx, want)))
    rec["timer_floor_ms"] = timer.floor_ms()
    emit(rec)
    return rec


# the slot loop's cross-attention: 16 slots, each padded to the largest
# bucket's S_max = 801 encoder frames (32 s) and masked past floor(len·S_w)
# of its own bucket (S_w = 25·seconds + 1 frames), for requests across the
# 2-32 s buckets; beam 1 in the chunk step, the prompt window (beam 3) when
# a full rung of 16 is primed
SLOT_SECONDS = (0.4, 2.0, 2.7, 3.1, 4.0, 5.5, 8.0, 9.9, 12.3, 16.0, 17.2,
                20.0, 24.5, 28.0, 31.0, 32.0)
SLOT_BUCKETS, S_MAX = (2.0, 4.0, 8.0, 16.0, 32.0), 801


def _slot_bias(torch):
    """(16, S_MAX) float32 bias as the continuous engine's admission makes
    it, and each slot's visible frame count."""
    abs_len = []
    for sec in SLOT_SECONDS:
        bucket = next(b for b in SLOT_BUCKETS if b >= sec)
        S_w = int(25 * bucket) + 1
        abs_len.append(math.floor(sec / bucket * S_w))
    lens = torch.tensor(abs_len, dtype=torch.float32, device="cuda")
    bias = torch.where(torch.arange(S_MAX, device="cuda")[None, :]
                       > lens[:, None], -1e9, 0.0).float().contiguous()
    return bias, [min(a, S_MAX - 1) + 1 for a in abs_len]


def _cross_slots(torch, K, timer, g):
    """decode_cross_attention at the slot loop's shapes (beam 1, and beam 3
    for prompt priming) with the per-slot bias, against its plain version:
    fp32 (TF32 off, ``simt``) and bf16 (``split``, bitwise over two
    launches), with times and bound; one line of phase kernel."""
    from stac_st_tpu_torch.ops import kernels

    name, R = "decode_cross_attention", len(SLOT_SECONDS)
    bias, n = _slot_bias(torch)
    rec = {"phase": "kernel", "name": name, "case": "slot_loop", "slots": R,
           "S": S_MAX, "seconds": list(SLOT_SECONDS), "visible": n}
    for beam in (1, 3):
        base = [torch.randn(shape, generator=g) * sc
                for shape, sc in (((R * beam, H, DH), 1 / 8),
                                  ((R, H, DH, S_MAX), 1),
                                  ((R, H, S_MAX, DH), 1))]
        for dtype in ("float32", "bfloat16"):
            q, kT, v = (t.to("cuda", getattr(torch, dtype)).contiguous()
                        for t in base)
            run = partial(K.decode_cross_attention, q, kT, v, bias, beam)
            plain = partial(K.decode_cross_attention_ref, q, kT, v, bias,
                            beam)
            variant = SPLIT if dtype == "bfloat16" else "simt"
            label = f"cross slot loop beam {beam} {dtype}"
            before = dict(kernels.launches)
            out = run()
            torch.cuda.synchronize()
            added = {k: c - before.get(k, 0)
                     for k, c in kernels.launches.items()
                     if c != before.get(k, 0)}
            check(added == {name: 1, f"{name}/{variant}": 1},
                  f"{label}: launched {added}")
            want = plain()
            err = (out.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(out).all()), f"{label} finite")
            check(err <= TOL[dtype], f"{label}: max abs err {err}")
            case = {"max_abs_err": err, "tol": TOL[dtype], "variant": variant}
            if dtype == "bfloat16":
                check(torch.equal(out, run()), f"{label} not repeatable")
                case["bitwise_repeatable"] = True
            es = q.element_size()
            b_ms, b_by = bound_ms(
                (2 * R * beam * H * DH + 2 * H * sum(n) * DH) * es
                + R * S_MAX * 4, 4.0 * beam * H * sum(n) * DH, dtype)
            case.update({"ms": timer.ms(run), "plain_ms": timer.ms(plain),
                         "library_ms": None, "bound_ms": b_ms,
                         "bound_by": b_by, "host_us": host_us(torch, run)})
            q_l, k_l, v_l, want_l = _cross_lib(q, kT, v, beam, want)
            case.update(sdpa_yardstick(torch, timer, q_l, k_l, v_l, want_l,
                                       (bias == 0)[:, None, None, :]))
            rec[f"beam{beam}_{dtype}"] = case
    rec["timer_floor_ms"] = timer.floor_ms()
    emit(rec)
    return rec


def _int8_like(torch, t, dim):
    """A float cache tensor quantized as the decode step appends it (one
    fp32 scale over ``dim``), on the card: (int8 values, scale)."""
    from stac_st_tpu_torch.models.transformer import quantize_rows

    return quantize_rows(t.to("cuda"), dim)


def _int8_case(torch, K, timer, label, run, plain, float_run, nbytes,
               flops, dtype, name, form=""):
    """One int8 kernel case: the launch counted by form, error against the
    plain version, two launches bitwise equal, times (kernel, plain, the
    float kernel on the dequantized values), bound and the timer's
    floor."""
    from stac_st_tpu_torch.ops import kernels

    variant = K.decode_variant(getattr(torch, dtype))
    want_added = {name: 1, f"{name}/{variant}": 1}
    if form:
        want_added.update({f"{name}/{form}": 1,
                           f"{name}/{form}/{variant}": 1})
    before = dict(kernels.launches)
    out = run()
    torch.cuda.synchronize()
    added = {k: c - before.get(k, 0) for k, c in kernels.launches.items()
             if c != before.get(k, 0)}
    check(added == want_added, f"{label}: launched {added}")
    want = plain()
    err = (out.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(out).all()), f"{label} finite")
    check(err <= TOL[dtype], f"{label}: max abs err {err} > {TOL[dtype]}")
    check(torch.equal(out, run()), f"{label} not repeatable")
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    return {"max_abs_err": err, "tol": TOL[dtype], "variant": variant,
            "bitwise_repeatable": True, "ms": timer.ms(run),
            "plain_ms": timer.ms(plain), "library_ms": None,
            "library": "none: no PyTorch call takes int8 K/V with scales",
            "float_kernel_ms": timer.ms(float_run),
            "bound_ms": b_ms, "bound_by": b_by,
            "timer_floor_ms": timer.floor_ms()}


def int8_kernel_cases(torch, K, timer):
    """The int8 cache's kernels against their plain versions at the main
    path's shapes, fp32 (TF32 off) and bf16: self at 160 rows x 195
    (idx 194) and at 16 rows idx 194, its ragged form at the slot loop's
    16 slots (ROWS_IDX), cross at B16 x beam 10 x 251 and at the slot
    loop's 16 x 801 with the per-slot bias (beam 1). Each beside the float
    kernel on the dequantized values. Two lines of phase kernel."""
    g = torch.Generator(device="cpu").manual_seed(2)
    name_s = "decode_self_attention_int8"
    name_c = "decode_cross_attention_int8"
    rec_s = {"phase": "kernel", "name": name_s}
    rec_c = {"phase": "kernel", "name": name_c}
    rows_rec = {"phase": "kernel", "name": f"{name_s}/rows",
                "rows": len(ROWS_IDX), "S": S_SELF, "idx": list(ROWS_IDX)}

    def per_pos(rows, n_pos, es, extra=0):
        # q read and output written, 2 Dh int8 and two fp32 scales a
        # position read
        return (2 * rows * H * DH * es + H * n_pos * (2 * DH + 8) + extra)

    def cache(rows, S):
        kT, ks = _int8_like(torch, torch.randn((rows, H, DH, S),
                                               generator=g), 2)
        v, vs = _int8_like(torch, torch.randn((rows, H, S, DH),
                                              generator=g), 3)
        return kT, v, ks, vs.transpose(2, 3).contiguous()

    def dequant(dt, kT, v, ks, vs):
        return ((kT.float() * ks).to(dt).contiguous(),
                (v.float() * vs.transpose(2, 3)).to(dt).contiguous())

    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        es = torch.finfo(dt).bits // 8
        # self, scalar form: 160 rows (beam 10 in gather mode), 16 rows
        for rows, key in ((B * BEAM, dtype), (B, f"{dtype}_rows16_idx194")):
            idx = S_SELF - 1
            kT, v, ks, vs = cache(rows, S_SELF)
            q = (torch.randn((rows, H, DH), generator=g)).to("cuda", dt)
            kf, vf = dequant(dt, kT, v, ks, vs)
            qs = (q.float() / 8).to(dt)
            rec_s[key] = _int8_case(
                torch, K, timer, f"self int8 {rows} rows {dtype}",
                partial(K.decode_self_attention_int8, q, kT, v, ks, vs, idx),
                partial(K.decode_self_attention_int8_ref, q, kT, v, ks, vs,
                        idx),
                partial(K.decode_self_attention, qs, kf, vf, idx),
                per_pos(rows, rows * S_SELF, es),
                4.0 * rows * H * S_SELF * DH, dtype, name_s)
        # the ragged form at the slot loop's 16 slots
        R = len(ROWS_IDX)
        kT, v, ks, vs = cache(R, S_SELF)
        q = torch.randn((R, H, DH), generator=g).to("cuda", dt)
        idx = torch.tensor(ROWS_IDX, dtype=torch.int32, device="cuda")
        n = sum(min(i, S_SELF - 1) + 1 for i in ROWS_IDX)
        kf, vf = dequant(dt, kT, v, ks, vs)
        rows_rec[dtype] = _int8_case(
            torch, K, timer, f"ragged self int8 {dtype}",
            partial(K.decode_self_attention_int8, q, kT, v, ks, vs, idx),
            partial(K.decode_self_attention_int8_ref, q, kT, v, ks, vs, idx),
            partial(K.decode_self_attention, (q.float() / 8).to(dt), kf, vf,
                    idx),
            per_pos(R, n, es, 4 * R), 4.0 * H * n * DH, dtype, name_s,
            form="rows")
        # cross: B16 x beam 10 x 251, then the slot loop's 16 x 801 with
        # the per-slot bias at beam 1
        bias, vis = _slot_bias(torch)
        for rows, S, beam, b, key in (
                (B, S_ENC, BEAM, None, dtype),
                (len(SLOT_SECONDS), S_MAX, 1, bias, f"{dtype}_slot_loop")):
            kT, v, ks, vs = cache(rows, S)
            q = torch.randn((rows * beam, H, DH), generator=g).to("cuda", dt)
            kf, vf = dequant(dt, kT, v, ks, vs)
            n_pos = rows * S if b is None else sum(vis)
            rec_c[key] = _int8_case(
                torch, K, timer, f"cross int8 {key}",
                partial(K.decode_cross_attention_int8, q, kT, v, ks, vs, b,
                        beam),
                partial(K.decode_cross_attention_int8_ref, q, kT, v, ks, vs,
                        b, beam),
                partial(K.decode_cross_attention, (q.float() / 8).to(dt),
                        kf, vf, b, beam),
                per_pos(rows * beam, 0, es) + H * n_pos * (2 * DH + 8)
                + (0 if b is None else rows * S * 4),
                4.0 * beam * H * n_pos * DH, dtype, name_c)
    for rec in (rec_s, rows_rec, rec_c):
        emit(rec)
    return [rec_s, rows_rec, rec_c]


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
# (self: bf16 and fp16; its ragged form is a kernel of its own)
SPLIT_KERNELS = {"self_split_kernel": 2, "self_split_rows_kernel": 2,
                 "cross_split_kernel": 2, "anc_split_kernel": 2,
                 "self_i8_split_kernel": 2, "self_i8_split_rows_kernel": 2,
                 "cross_i8_split_kernel": 2}
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


def flagship(seed: int, enc: int = 12, dec: int = 6, dropout: float = 0.1,
             **settings):
    """The flagship preset's modules with seeded Glorot weights (CPU);
    ``enc``/``dec`` cut the depth only; ``settings`` go to the
    transformer (e.g. ``normalize_before=False``)."""
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
            num_decoder_layers=dec, d_ffn=1024, dropout=dropout,
            **settings),
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
    return rec, st, st1


# the int8 phase: the main path's engine with the int8 KV cache, int8
# weights, and both; 6 decoder layers x 195 steps a search
INT8_OPTIONS = (("kv_int8", dict(kv_cache_dtype="int8")),
                ("weights_int8", dict(weights_int8=True)),
                ("both", dict(kv_cache_dtype="int8", weights_int8=True)))
# fp32 card vs CPU, one decode step's logits: int8 weights quantize the
# same fp32 values on both devices into the same int8, so the float
# tolerance holds; the int8 cache quantizes K/V rows that agree to fp32
# rounding, and a value whose x/s lies within rounding of a .5 moves by
# one int8 step (about 1/127 of its row's largest value, then averaged
# by the attention weights)
INT8_CARD_VS_CPU_ATOL = {"weights_int8": 1e-3, "kv_int8": 1e-2,
                         "both": 1e-2}


def int8_beam1(torch, kernels, bf16_texts):
    """main_path's beam-1 translate of 2 x 10 s with the int8 KV cache: the
    scalar split self form in a decode loop. Exact launch counts of the
    warm call (1170 int8 self and 1170 int8 cross, all split), its wall
    time, and its texts against the bf16 beam-1 call's (printed: int8
    reorders near ties)."""
    wavs = serving_wavs()[:2]
    per_search = 6 * S_SELF
    eng = engine(flagship(0), "cuda", bf16=True, beam_size=1,
                 max_decode_tokens=192, transfer_dtype="int16",
                 kv_cache_dtype="int8")
    eng.translate(wavs)  # first call: set-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.translate(wavs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    want = {f"{n}{v}": per_search
            for n in ("decode_self_attention_int8",
                      "decode_cross_attention_int8")
            for v in ("", f"/{SPLIT}")}
    check(launches == want, f"int8 beam 1: launches {launches}, want {want}")
    check(len(out) == 2 and all(out), "int8 beam-1 texts")
    return {"translate_warm_s": wall, "rtfx": 2 * SECONDS / wall,
            "launches": launches,
            "bf16_agreement": {"equal": sum(a == b for a, b in
                                            zip(out, bf16_texts)),
                               "of": 2}}


def int8_phase(torch, kernels, bf16_texts, bf16_beam1, main_rec,
               profile: bool):
    """translate of B16 x 10 s at the main path's settings (bf16, beam 10,
    192 tokens, PCM16) with the int8 KV cache (the searcher's gather mode),
    int8 weights, and both: warm RTFx beside main_path's bf16 number from
    this run, exact launch counts of the warm call (zeroed just before;
    the int8 kernels by variant, all split), token agreement with the bf16
    engine (printed: int8 reorders near-tied beams); --profile traces the
    int8 cache's call (the gather copy's and the int8 kernels' device
    time). Then main_path's beam-1 call with the int8 cache
    (:func:`int8_beam1`), and an fp32 engine (TF32 off) with each option,
    card against CPU: one decode step's logits."""
    wavs = serving_wavs()
    audio_s = B * SECONDS
    per_search = 6 * S_SELF
    rec = {"phase": "int8", "batch": B, "seconds": SECONDS, "beam": BEAM,
           "bf16_translate_warm_rtfx": main_rec["translate_warm_rtfx"]}
    t_phase = time.perf_counter()
    for label, opts in INT8_OPTIONS:
        eng = engine(flagship(0), "cuda", bf16=True, beam_size=BEAM,
                     max_decode_tokens=192, transfer_dtype="int16", **opts)
        eng.translate(wavs)  # first call: set-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = eng.translate(wavs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
        if "kv_cache_dtype" in opts:
            want = {"decode_self_attention_int8": per_search,
                    "decode_self_attention_int8/split": per_search,
                    "decode_cross_attention_int8": per_search,
                    "decode_cross_attention_int8/split": per_search}
        else:
            want = {"decode_self_attention_anc": per_search,
                    "decode_self_attention_anc/split": per_search,
                    "decode_cross_attention": per_search,
                    "decode_cross_attention/split": per_search}
        got = {k: v for k, v in launches.items() if "/" not in k
               or k.endswith("/split")}
        check(got == want, f"int8 {label}: launches {launches}, want {want}")
        case = {"options": opts, "translate_warm_s": wall,
                "translate_warm_rtfx": audio_s / wall, "launches": launches,
                "bf16_agreement": {"equal": sum(a == b for a, b in
                                                zip(out, bf16_texts)),
                                   "of": B}}
        if profile and label == "kv_int8":
            case["profile"] = profile_call(
                torch, lambda: eng.translate(wavs), wall,
                "translate_int8_cache",
                # index_select runs as the gather kernel: the reorder
                watch=("vectorized_gather_kernel", "self_i8_split_kernel",
                       "cross_i8_split_kernel"))
        rec[label] = case
        del eng
    rec["beam1_kv_int8"] = int8_beam1(torch, kernels, bf16_beam1)
    rec["projections"] = decoder_projections(torch)
    # fp32, TF32 off: one decode step on the card against the CPU
    rng = np.random.default_rng(1)
    short = [(0.1 * rng.standard_normal(int(2 * SR))).astype(np.float32)
             for _ in range(2)]
    for label, opts in INT8_OPTIONS:
        logits = {}
        for dev in ("cuda", "cpu"):
            eng = engine(flagship(1), dev, bf16=False, beam_size=BEAM,
                         max_decode_tokens=16, **opts)
            with torch.inference_mode():
                (_, batch, lens), = eng._prepare(short)
                enc = eng._encode(batch, lens)
                model = eng._transformer
                kv = opts.get("kv_cache_dtype")
                cache = model.init_decode_cache(
                    enc, 4, None, BEAM, anc_mode=kv is None, cache_dtype=kv)
                for p, tok in enumerate(eng._prompt("es", "en")):
                    toks = torch.full((2 * BEAM,), tok, dtype=torch.long,
                                      device=enc.device)
                    out = eng.searcher.seq_lin(
                        model.decode_step(toks, p, cache))
            logits[dev] = out.float().cpu()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        tol = INT8_CARD_VS_CPU_ATOL[label]
        check(err <= tol, f"int8 {label} card vs CPU logits: {err} > {tol}")
        rec[label]["card_vs_cpu_fp32"] = {"logits_max_abs_err": err,
                                          "atol": tol}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def decoder_projections(torch):
    """The weight products of one decoder step at the main path's 160
    rows (6 layers: the self-attention q/k/v and out-projection, the
    cross-attention q and out-projection, fc1 and fc2; the seq_lin head),
    bf16 weights against int8 ones (the engine's int8 modules, plain
    PyTorch), each timed as one call over all of them with the L2
    flushed: ms, calls and the weight bytes read."""
    from stac_st_tpu_torch.utils.quantize import quantize_decode_weights

    out = {}
    for label in ("bfloat16", "int8"):
        mods = flagship(0)
        tr, head = mods["transformer"], mods["seq_lin"]
        for m in (tr, head):
            m.to("cuda", torch.bfloat16).eval()
        if label == "int8":
            quantize_decode_weights(tr, head)
        x = torch.randn((B * BEAM, 256), device="cuda", dtype=torch.bfloat16)
        h = torch.randn((B * BEAM, 1024), device="cuda", dtype=torch.bfloat16)
        calls, nbytes = [], 0
        for layer in tr.decoder.layers:
            sa, ca, ffn = layer.self_attn, layer.cross_attn, layer.ffn
            calls += [partial(sa.in_proj, x), partial(sa.out_proj, x),
                      partial(ca._proj, x, 0), partial(ca.out_proj, x),
                      partial(ffn.fc1, x), partial(ffn.fc2, h)]
            q = ca.in_proj.q if label == "int8" else None
            for m in (sa.in_proj, sa.out_proj, q, ca.out_proj, ffn.fc1,
                      ffn.fc2):
                # the weights read (int8 with their scales); the float
                # cross q reads the first d rows of its in_proj
                nbytes += (256 * 256 * 2 if m is None else
                           m.weight.numel() * m.weight.element_size()
                           + getattr(m, "scale", m.weight[:0]).numel() * 4)
        calls.append(partial(head, x))
        w = head.linear.weight
        nbytes += w.numel() * w.element_size() + (
            head.linear.scale.numel() * 4 if label == "int8" else 0)

        def step():
            with torch.inference_mode():
                for c in calls:
                    c()

        out[label] = {"ms": Timer(torch).ms(step), "calls": len(calls),
                      "weight_bytes": nbytes}
    return out


# the speculative phase: a flagship target, a d256 2 + 2-layer draft of its
# own seeded weights, k = 6, four utterances of 2-10 s decoded one at a time
SPEC_K, SPEC_SECONDS, SPEC_TOKENS = 6, (2.0, 4.5, 7.0, 10.0), 64


def _spec_texts(torch, spec, target, wavs):
    """The speculative engine's and the target's beam-1 texts of each
    utterance alone (the fbank's top-dB clamp couples a batch's rows), the
    speculative wall seconds and its stats."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, stats = [], []
    for w in wavs:
        got += spec.translate([w])
        stats += spec.last_stats
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = [target.translate([w])[0] for w in wavs]
    # the speculative text keeps an emitted eos (w2), as the reference's
    # does; the search's hypotheses never hold it
    got = [" ".join(t.split()[:-1]) if t.split()[-1:] == ["w2"] else t
           for t in got]
    return got, want, wall, stats


def speculative_phase(torch, kernels):
    """SpeculativeSTEngine (target: flagship width, 12 + 6 layers; draft:
    d256, 2 + 2 layers, its own seeded weights; the synthetic tokenizer;
    k = 6; at most SPEC_TOKENS tokens) on four utterances of 2-10 s. In
    fp32 (TF32 off) its texts must equal the target's beam-1 translate of
    each utterance, with float caches and with both engines on the int8
    cache; in bf16 the agreement is printed. Tokens per target step, RTFx
    and the launches of the fp32 float run."""
    from stac_st_tpu_torch.serving import SpeculativeSTEngine

    rng = np.random.default_rng(5)
    wavs = [(0.1 * rng.standard_normal(int(sec * SR))).astype(np.float32)
            for sec in SPEC_SECONDS]
    audio_s = sum(SPEC_SECONDS)
    rec = {"phase": "speculative", "k": SPEC_K, "seconds": SPEC_SECONDS,
           "max_decode_tokens": SPEC_TOKENS}
    t_phase = time.perf_counter()
    for label, bf16, kv in (("fp32", False, None), ("fp32_int8", False,
                                                    "int8"),
                            ("bf16", True, None)):
        opts = dict(bf16=bf16, beam_size=1, max_decode_tokens=SPEC_TOKENS,
                    kv_cache_dtype=kv)
        target = engine(flagship(0), "cuda", **opts)
        draft = engine(flagship(7, enc=2, dec=2), "cuda", **opts)
        spec = SpeculativeSTEngine(target, draft, k=SPEC_K)
        spec.warmup()
        kernels.reset_launches()
        got, want, wall, stats = _spec_texts(torch, spec, target, wavs)
        launches = dict(kernels.launches)
        equal = sum(a == b for a, b in zip(got, want))
        if not bf16:
            check(equal == len(wavs), f"speculative {label}: {equal} of "
                  f"{len(wavs)} equal to the target's beam-1 decode")
        tokens = sum(st["tokens"] for st in stats)
        steps = sum(st["target_steps"] for st in stats)
        rec[label] = {"equal_to_target_beam1": equal, "of": len(wavs),
                      "tokens": tokens, "target_steps": steps,
                      "tokens_per_target_step": tokens / steps,
                      "drafted": sum(st["drafted"] for st in stats),
                      "wall_s": wall, "rtfx": audio_s / wall,
                      "launches": launches}
    rec["phase_s"] = time.perf_counter() - t_phase
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
    the same call's wall time without the profiler, or, given None, with
    it). The table goes to
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
            "device_idle_share": 1.0 - busy_us / 1e6 / (wall_unprofiled
                                                         or wall),
            # the profiler's host cost is inside a profiled wall: a share
            # taken against it is not comparable with one taken against
            # an unprofiled run
            "idle_share_against": ("unprofiled wall" if wall_unprofiled
                                   else "profiled wall"),
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


def _trainer(torch, mods, bf16: bool, speed_perturb=None, run_opts=None):
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
    return STTrainer(modules, AdamW(lr=1e-3), hparams, run_opts,
                     device="cuda")


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
    off = attn_off_step(torch, kernels, trainer, batch)
    rec = {"phase": "train", "batch": TB, "seconds": SECONDS_TRAIN,
           "dtype": "bfloat16", "dropout": 0.1, "steps": len(steps),
           "step_ms": [x * 1e3 for x in steps], "warm_step_ms": warm * 1e3,
           "audio_s_per_s": TB * SECONDS_TRAIN / warm,
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "launches_fit": launches, "launches_eval": eval_launches,
           "specaugment_card_vs_cpu_err": aug_err,
           "train_attn_kernel_off": off}
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


def _warm_step(torch, trainer, dev_batch):
    """(ms, peak GB) of one train step after a first one, the peak reset
    just before it."""
    state = trainer.ensure_state()
    trainer.train_step(state, dev_batch, trainer.next_seed())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.train_step(state, dev_batch, trainer.next_seed())
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 1e9)


def attn_off_step(torch, kernels, kernel_trainer, batch) -> dict:
    """Phase train's cell with train_attn_kernel=off (the model's matmul +
    softmax attention, dropout on the weights): a warm step's ms and peak
    beside the kernel route's, measured the same way, and no launch of
    the four flash kernels in that step or in the eval forward."""
    trainer = _trainer(torch, flagship(0), bf16=True,
                       run_opts={"train_attn_kernel": "off"})
    dev_batch = trainer._device_batch(batch)
    trainer.ensure_state()
    kernels.reset_launches()
    ms, peak = _warm_step(torch, trainer, dev_batch)
    trainer.eval_forward(trainer.state.params, trainer.state.cmvn, dev_batch)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(not any(launches.get(n) for n in FLASH),
          f"train_attn_kernel=off launched a flash kernel: {launches}")
    del trainer
    k_ms, k_peak = _warm_step(torch, kernel_trainer,
                              kernel_trainer._device_batch(batch))
    return {"warm_step_ms": ms, "peak_memory_gb": peak,
            "kernel_warm_step_ms": k_ms, "kernel_peak_memory_gb": k_peak,
            "launches": launches}


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


def write_corpus(root: str, seed: int = 0, count: int = N_CORPUS):
    """``count`` utterances (N_CORPUS) of 12-15 s of seeded
    noise-and-tone audio at 8 kHz, as PCM16 WAV (every eighth entry two
    files that the loader concatenates; one entry a mu-law SPHERE file), a
    training manifest in the reference schema (half ASR rows, half ES->EN
    rows; pseudo-word text, some rows with [turn] or [turn] [xt]) and the
    joint text lines for the tokenizer. Returns (manifest path, joint
    lines, audio s)."""
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
    for i in range(count):
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


# the recipe phase: recipes/hparams/transformer_multitask.yaml as it ships
# (full width, host SpeedPerturb, SpecAugment, accumulation 16) through the
# port's recipe entry point, on the data_train corpus split into the
# recipe's {data_folder}/{split}.json layout
RECIPE_YAML = os.path.join(ROOT, "recipes", "hparams",
                           "transformer_multitask.yaml")
# 512 training utterances give about 17 batches of 450 s an epoch, so the
# YAML's 16-microbatch accumulation applies an update in each epoch
N_TRAIN, N_DEV, N_HELDOUT = 512, 16, 16
SIGTERM_AFTER = 3  # batches of epoch 1 before the in-process SIGTERM
RECIPE_DECODE = ("decode_self_attention_anc", "decode_cross_attention")


def recipe_corpus(root: str):
    """write_corpus, split: ``train`` (ASR and ST rows), ``dev`` (N_DEV ST
    rows), ``heldout/data-asr`` (N_HELDOUT transcription rows) and
    ``heldout/data-st`` (the same utterances' translation rows, four
    references); a BPE tokenizer
    trained on the text as data_train trains it ([es] [en] [turn] [xt] are
    3-6). Returns (tokenizer path, heldout audio paths)."""
    from stac_st_tpu_torch.tokenizer import train_bpe

    n_tail = N_DEV + N_HELDOUT
    path, lines, _ = write_corpus(root, count=N_TRAIN + 2 * n_tail)
    with open(path) as f:
        entries = json.load(f)
    ids = list(entries)
    # ST rows (odd rows) carry both texts: transcription and translation_0
    tail = [u for u in ids[N_TRAIN:] if entries[u]["task"] == "translation"]
    check(len(tail) == n_tail, f"{len(tail)} ST rows for dev and heldout")
    dev, heldout = tail[:N_DEV], tail[N_DEV:]
    train = [u for u in ids if u not in set(tail)]
    asr = {u: {**entries[u], "task": "transcription", "target_lang": "es",
               "translation_0": entries[u]["transcription"]} for u in heldout}
    st = {u: {**entries[u], **{f"translation_{k}": entries[u]["translation_0"]
                               for k in range(4)}} for u in heldout}
    os.makedirs(os.path.join(root, "heldout"), exist_ok=True)
    for name, part in (("train", {u: entries[u] for u in train}),
                       ("dev", {u: entries[u] for u in dev}),
                       ("heldout/data-asr", asr), ("heldout/data-st", st)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(part, f, indent=1)
    model = train_bpe(lines, vocab_size=600,
                      user_defined_symbols=["[es]", "[en]", "[turn]", "[xt]"])
    tok = os.path.join(root, "bpe.model")
    model.save(tok)
    wavs = [entries[u]["wav"].split()[0].replace("{data_root}", root)
            for u in heldout]
    return tok, wavs


class _Feed:
    """Passes the recipe's train loader through: records the audio seconds
    of each batch it hands over, and in the run it arms raises SIGTERM
    in-process after the ``after``-th batch of the first epoch
    (tests/test_e2e.py's deterministic preemption)."""

    def __init__(self, loader, after=None):
        self.loader, self.after = loader, after
        self.fired, self.seconds = False, []

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        import signal

        for i, batch in enumerate(self.loader):
            self.seconds.append(float(np.sum(batch.duration)))
            yield batch
            if self.after and not self.fired and i + 1 >= self.after:
                self.fired = True
                signal.raise_signal(signal.SIGTERM)


def trees_equal(a, b) -> bool:
    """Nested dicts of arrays and scalars, bitwise (and dtype) equal."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and sorted(a) == sorted(b)
                and all(trees_equal(a[k], b[k]) for k in a))
    x, y = np.asarray(a), np.asarray(b)
    return (x.dtype == y.dtype and x.shape == y.shape
            and x.tobytes() == y.tobytes())


def model_tree(cnn, transformer, seq_lin, ctc_lin):
    from stac_st_tpu_torch.interop.from_jax import to_jax_params

    return to_jax_params(cnn, transformer, seq_lin, ctc_lin)


def resume_check(trainer, ckpt) -> dict:
    """The trainer's state just after resuming from ``ckpt`` against the
    trees the checkpoint holds, bitwise: parameters, Adam's moments, the
    accumulator, the optimizer's counts, the step-seed generator, CMVN and
    the counters; the epoch counter re-enters the preempted epoch."""
    st, cfg = trainer.state, trainer.cfg
    opt, norm = ckpt.load("opt_torch"), ckpt.load("normalizer")
    counters = ckpt.load("counters")
    host = {k: getattr(st.opt_state, k).cpu().numpy()
            for k in ("mu", "nu", "count", "notfinite", "acc")
            if getattr(st.opt_state, k) is not None}
    return {
        "params": trees_equal(model_tree(cfg.cnn, cfg.transformer,
                                         cfg.seq_lin, cfg.ctc_lin),
                              ckpt.load("model")),
        "moments": trees_equal(host, {k: opt[k] for k in host}),
        "opt_counts": (st.opt_state.sched_count == opt["sched_count"]
                       and st.opt_state.mini_step == opt["mini_step"]),
        "generator": trees_equal(trainer.generator.get_state().numpy(),
                                 opt["generator"]),
        "cmvn": trees_equal({k: getattr(st.cmvn, k).cpu().numpy()
                             for k in ("mean", "std", "count")}, norm),
        "counters": (st.optimizer_step == counters["optimizer_step"]
                     and st.micro_step == counters["micro_step"]),
        "epoch_reentered": (trainer.hparams["epoch_counter"].current
                            == counters["epoch"] - 1),
    }


def recipe_run(torch, kernels, root: str) -> dict:
    """The recipe twice from its YAML on the card (SIGTERM in the first
    run, resume in the second), then the saved experiment through
    STEngine. Checks as the phase states; returns its record."""
    import contextlib
    import signal

    from stac_st_tpu_torch.recipes import train_multitask as R
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.training.checkpoint import (
        Checkpointer,
        average_checkpoints,
    )

    sync = torch.cuda.synchronize
    rec = {"yaml": os.path.relpath(RECIPE_YAML, ROOT),
           "train_utterances": N_TRAIN, "dev_utterances": N_DEV,
           "heldout_utterances": N_HELDOUT, "sigterm_after": SIGTERM_AFTER}
    t0 = time.perf_counter()
    tok, wavs = recipe_corpus(root)
    rec["corpus_and_tokenizer_s"] = time.perf_counter() - t0
    out = os.path.join(root, "exp")
    args = [RECIPE_YAML, "--device=cuda", f"--data_folder={root}",
            f"--tokenizer_file={tok}", f"--output_folder={out}",
            "--train_splits=train", "--dev_splits=dev",
            "--test_splits_4_translations=[heldout/data-st]",
            "--test_splits_1_translations=[heldout/data-asr]",
            "--number_of_epochs=2", "--valid_search_interval=1",
            "--num_workers=4", "--no_eval=False", "--n_warmup_steps=10",
            "--turn=5", "--xt=6"]
    rec["overrides"] = args[1:]

    runs = []
    base = R.STTrainer

    class Recorded(base):
        """The recipe's trainer, recording each stage's wall time, the
        validation stats and launches, and the state just after resume."""

        def load_from_checkpoint(self, ckpt):
            super().load_from_checkpoint(ckpt)
            runs[-1]["resumed_from"] = os.path.basename(ckpt.path)
            runs[-1]["resume"] = resume_check(self, ckpt)

        def fit(self, *a, **kw):
            t = time.perf_counter()
            super().fit(*a, **kw)
            sync()
            runs[-1]["fit_s"] = time.perf_counter() - t

        def _validate(self, valid_set, epoch):
            before = dict(kernels.launches)
            t = time.perf_counter()
            stats = super()._validate(valid_set, epoch)
            sync()
            runs[-1]["valid"].append({
                "epoch": epoch, **stats,
                "valid_s": time.perf_counter() - t,
                "search_s": self.valid_search_s,
                "launches": {k: v - before.get(k, 0)
                             for k, v in kernels.launches.items()
                             if v != before.get(k, 0)}})
            return stats

        def evaluate(self, test_set, *a, **kw):
            t = time.perf_counter()
            stats = super().evaluate(test_set, *a, **kw)
            sync()
            runs[-1]["evaluate"].append({
                "bleu_file": os.path.basename(self.hparams["bleu_file"]),
                **stats, "s": time.perf_counter() - t})
            return stats

    prepare = R.dataio_prepare
    feeds = []

    def prepared(hparams):
        datasets, loaders = prepare(hparams)
        loaders["train"] = _Feed(loaders["train"],
                                 SIGTERM_AFTER if not feeds else None)
        feeds.append(loaders["train"])
        return datasets, loaders

    chained = []

    def marker(signum, frame):
        chained.append(signum)

    outer = signal.signal(signal.SIGTERM, marker)
    R.STTrainer, R.dataio_prepare = Recorded, prepared
    kernels.reset_launches()
    try:
        with open(os.path.join(OUT_DIR, "recipe_log_cuda.txt"),
                  "w") as log, contextlib.redirect_stdout(log):
            trainers = []
            for _ in range(2):
                runs.append({"valid": [], "evaluate": []})
                t = time.perf_counter()
                trainers.append(R.main(args))
                sync()
                runs[-1]["main_s"] = time.perf_counter() - t
                if len(trainers) == 1:
                    check(signal.getsignal(signal.SIGTERM) is marker,
                          "fit restored the previous SIGTERM handler")
    finally:
        R.STTrainer, R.dataio_prepare = base, prepare
        signal.signal(signal.SIGTERM, outer)
    first, second = trainers

    # run 1: stopped by SIGTERM after SIGTERM_AFTER batches, a preempted
    # checkpoint, no validation, the handler chained and restored
    check(feeds[0].fired and first.preempted, "SIGTERM fired and stopped fit")
    check(chained == [signal.SIGTERM], f"previous handler called {chained}")
    # the signal lands while the loader fetches the next batch: that
    # batch's step runs, then fit checkpoints and returns
    done = len(feeds[0].seconds)
    check(first.state.micro_step == done == SIGTERM_AFTER + 1,
          f"run 1 took {first.state.micro_step} steps")
    check(not runs[0]["valid"] and not runs[0]["evaluate"],
          "no validation or evaluation after SIGTERM")
    save = Checkpointer(os.path.join(out, "save"))
    pre = [c for c in save.list_checkpoints() if c.meta.get("preempted")]
    check(len(pre) == 1 and pre[0].meta["epoch"] == 1
          and len(pre[0].meta["epoch_losses"]) == done,
          f"preempted checkpoints {[c.meta for c in pre]}")
    # run 2: resumed from it, bitwise; re-entered epoch 1, read its first
    # `done` batches again without training them, then epoch 2
    check(runs[1].get("resumed_from") == os.path.basename(pre[0].path),
          "run 2 resumed from the preempted checkpoint")
    check(all(runs[1]["resume"].values()), f"resume {runs[1]['resume']}")
    check([v["epoch"] for v in runs[1]["valid"]] == [1, 2],
          "validated epochs 1 and 2")
    check(second.state.micro_step == len(feeds[1].seconds),
          f"micro steps across the resume: {second.state.micro_step} for "
          f"{len(feeds[1].seconds)} batches in 2 epochs")
    check(second.state.optimizer_step
          == second.state.micro_step // second.tx.accum,
          f"optimizer steps {second.state.optimizer_step}")
    for v in runs[1]["valid"]:
        check(all(np.isfinite(v[k]) for k in ("loss", "ACC", "BLEU", "WER",
                                              "BLEU_no_turn", "WER_no_turn")),
              f"valid stats {v}")
        check(all(v["launches"].get(f"{n}/simt", 0) > 0
                  and not v["launches"].get(f"{n}/{SPLIT}")
                  for n in RECIPE_DECODE),
              f"validation searches in fp32 (simt): {v['launches']}")
    acc = save.find_checkpoints(max_key="ACC")
    check(1 <= len(acc) <= 5 and sorted(c.meta["epoch"] for c in acc)
          == [1, 2], f"ACC checkpoints {[c.meta for c in acc]}")
    avg = average_checkpoints(acc, "model")
    cfg = second.cfg
    check(trees_equal(model_tree(cfg.cnn, cfg.transformer, cfg.seq_lin,
                                 cfg.ctc_lin), avg),
          "evaluation ran on the average of the kept checkpoints")
    files = sorted(f for f in os.listdir(out)
                   if f.startswith(("bleu_", "wer_")))
    check(files == ["bleu_heldout_data-st.csv", "bleu_heldout_data-st.txt",
                    "bleu_heldout_data-st_no_turn.csv",
                    "bleu_heldout_data-st_no_turn.txt",
                    "wer_heldout_data-asr.csv", "wer_heldout_data-asr.txt",
                    "wer_heldout_data-asr_no_turn.csv",
                    "wer_heldout_data-asr_no_turn.txt"], f"files {files}")
    # YAML objects shared by !ref: one module under every key
    hp = second.hparams
    check(hp["valid_search"].model is hp["test_search"].model
          is hp["modules"]["Transformer"] is cfg.transformer
          and list(hp["model"]) == [cfg.cnn, cfg.transformer, cfg.seq_lin,
                                    cfg.ctc_lin]
          and hp["checkpointer"].recoverables["model"] is hp["model"],
          "YAML references share the modules")

    # the saved experiment, reloaded from its own config, serves
    t = time.perf_counter()
    eng = STEngine.from_saved_experiment(out, device="cuda", bf16=False)
    sync()
    load_s = time.perf_counter() - t
    check(trees_equal(model_tree(eng._cnn, eng._transformer,
                                 eng.searcher.seq_lin, eng._ctc_lin), avg),
          "from_saved_experiment loads the trainer's average")
    audio = [eng.load_audio(w) for w in wavs]
    before = dict(kernels.launches)
    t = time.perf_counter()
    texts = eng.translate(audio)
    sync()
    translate_s = time.perf_counter() - t
    launches = dict(kernels.launches)
    check(len(texts) == len(wavs) and all(isinstance(x, str) for x in texts),
          "translate")
    trained = [sum(feeds[0].seconds), sum(feeds[1].seconds[done:])]
    rec.update({
        "run1": runs[0], "run2": runs[1],
        # audio trained: run 2 reads run 1's batches again untrained
        "fit_audio_s": trained,
        "fit_audio_s_per_s": [
            a / (r["fit_s"] - sum(v["valid_s"] for v in r["valid"]))
            for a, r in zip(trained, runs)],
        "checkpoints_kept": [{"ACC": c.meta["ACC"], "epoch": c.meta["epoch"]}
                             for c in acc],
        "optimizer_steps": second.state.optimizer_step,
        "engine_load_s": load_s, "translate_s": translate_s,
        "translate_audio_s": sum(len(a) for a in audio) / SR,
        "translations": texts[:2], "launches": launches,
        "launches_translate": {k: v - before.get(k, 0)
                               for k, v in launches.items()
                               if v != before.get(k, 0)}})
    return rec


def recipe_phase(torch, kernels, smi: str, root: str):
    """The canonical recipe at full width on the card (recipe_run), its
    corpus and experiment under ``root``."""
    t0 = time.perf_counter()
    rec = recipe_run(torch, kernels, root)
    rec["phase_s"] = time.perf_counter() - t0
    launches = rec["launches"]
    for name in RECIPE_DECODE + FLASH:
        check(launches.get(name, 0) > 0, f"recipe launched no {name}")
    emit({"phase": "recipe", "gpu": smi, **rec})
    return rec


# the serve phase: the recipe's experiment behind the port's HTTP front,
# as `python -m stac_st_tpu_torch.recipes.serve EXP_DIR` runs it
SERVE_ARGS = ["--transport", "http", "--http-port", "0", "--max-batch", "16",
              "--pad-batch", "4,16"]
SLOTS, CHUNK = 16, 16           # bench_serve.py's continuous defaults
CLIENTS, LOAD_S = 16, 20.0      # concurrent clients, load window (s)
REQUEST_S = (2.0, 16.0)         # request lengths (s)
N_EXACT, N_FINAL = 8, 6         # continuous vs oracle; protocol finals
INT8_LOAD_S = 10.0              # the fp32 int8 slot loop's load window (s)
INT8_BF16_LOAD_S = 5.0          # the bf16 int8 slot loop's load window (s)
CONVERSATION_S = 60.0           # the long-form input, at least


class Refs:
    """Counts calls of the decode kernels' plain versions on CUDA tensors
    while active (the wrappers reach them through the module's names)."""

    NAMES = ("decode_self_attention_ref", "decode_self_attention_anc_ref",
             "decode_cross_attention_ref")

    def __init__(self, K):
        self.K, self.cuda_calls, self.saved = K, 0, {}

    def __enter__(self):
        for n in self.NAMES:
            fn = self.saved[n] = getattr(self.K, n)

            def counted(*args, _fn=fn, **kw):
                if any(getattr(a, "is_cuda", False) for a in args):
                    self.cuda_calls += 1
                return _fn(*args, **kw)

            setattr(self.K, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.K, n, fn)


def http_post(port: int, path: str, body: bytes, timeout: float = 300.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, json.loads(r.read())


def to_pcm16(wav: np.ndarray) -> np.ndarray:
    return np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)


def pcm16_body(wav: np.ndarray) -> bytes:
    """A request body carrying ``wav`` as PCM16, base64."""
    import base64

    return json.dumps({"audio_pcm16_b64": base64.b64encode(
        to_pcm16(wav).tobytes()).decode()}).encode()


def serve_audio(eng, root: str):
    """The recipe corpus's first 24 utterances at 16 kHz; a pool of 64
    requests of 2-16 s cut from them (PCM16-base64 bodies, with their
    seconds); a conversation of at least 60 s: utterances between pauses
    of 0.6-1.4 s of -60 dB noise."""
    with open(os.path.join(root, "train.json")) as f:
        entries = json.load(f)
    utts = []
    for uid in list(entries)[:24]:
        utts.append(np.concatenate([
            eng.load_audio(p.replace("{data_root}", root))
            for p in entries[uid]["wav"].split()]).astype(np.float32))
    rng = np.random.default_rng(10)
    stream = np.concatenate(utts)
    pool = []
    for _ in range(64):
        n = int(rng.uniform(*REQUEST_S) * SR)
        a = int(rng.integers(0, len(stream) - n))
        pool.append((stream[a:a + n], n / SR))
    parts, total = [], 0.0
    for u in utts:
        pause = 0.001 * rng.standard_normal(int(rng.uniform(0.6, 1.4) * SR))
        parts += [pause.astype(np.float32), u]
        total += (len(pause) + len(u)) / SR
        if total >= CONVERSATION_S:
            break
    parts.append(np.zeros(SR // 2, np.float32))
    return utts, pool, np.concatenate(parts)


class Stages:
    """Wall seconds and calls of named methods of one object, while active
    (each ends in a host read, so device work is included); the serving
    workers are serial, so seconds over the window's wall is the share of
    it each stage held the worker."""

    def __init__(self, obj, names):
        self.obj, self.names, self.s, self.calls = obj, names, {}, {}

    def __enter__(self):
        for n in self.names:
            fn = getattr(self.obj, n)

            def run(*a, _fn=fn, _n=n, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.s[_n] = self.s.get(_n, 0.0) + time.perf_counter() - t
                    self.calls[_n] = self.calls.get(_n, 0) + 1

            setattr(self.obj, n, run)
        return self

    def __exit__(self, *exc):
        for n in self.names:
            delattr(self.obj, n)

    def report(self, wall: float) -> dict:
        return {n: {"s": self.s.get(n, 0.0), "calls": self.calls.get(n, 0),
                    "share_of_wall": self.s.get(n, 0.0) / wall}
                for n in self.names}


def load_window(port: int, pool, seconds: float = LOAD_S) -> dict:
    """CLIENTS threads post /v1/translate (PCM16-base64) back to back for
    ``seconds``: sustained RTFx (audio served over the wall time until the
    last answer), latency percentiles, failures."""
    import threading

    bodies = [(pcm16_body(w), sec) for w, sec in pool]
    lat, audio, failed = [], [], []
    lock = threading.Lock()
    t_end = time.perf_counter() + seconds

    def client(c):
        rng = np.random.default_rng(100 + c)
        while time.perf_counter() < t_end:
            body, sec = bodies[int(rng.integers(len(bodies)))]
            t = time.perf_counter()
            code, r = http_post(port, "/v1/translate", body)
            dt = time.perf_counter() - t
            with lock:
                if code == 200 and isinstance(r.get("text"), str):
                    lat.append(dt)
                    audio.append(sec)
                else:
                    failed.append(code)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not failed and lat, f"load: {len(failed)} failed ({failed[:5]})")
    ms = np.asarray(lat) * 1e3
    return {"clients": CLIENTS, "window_s": seconds, "requests": len(lat),
            "audio_s": float(sum(audio)), "wall_s": wall,
            "rtfx": float(sum(audio)) / wall,
            "latency_ms": {f"p{q}": float(np.percentile(ms, q))
                           for q in (50, 95, 99)}}


def greedy_oracle(eng, S_max: int, cap: int, wav, src: str, tgt: str):
    """One utterance decoded greedily, alone, as the slot loop's admission
    computes it (encode one row, pad to S_max, the floor(len · S_w) bias,
    the prompt through decode_window, the budget min(frames, cap)), then
    scalar decode steps through the scalar self kernel. Its tokens."""
    import torch

    with torch.inference_mode():
        return _greedy_oracle(torch, eng, S_max, cap, wav, src, tgt)


def _greedy_oracle(torch, eng, S_max, cap, wav, src, tgt):
    model, dev = eng._transformer, eng.device
    width = eng._bucket_width(len(wav))
    batch = np.zeros((1, width), np.float32)
    batch[0, : len(wav)] = wav
    lens = torch.tensor([len(wav) / width], dtype=torch.float32, device=dev)
    enc = eng._encode(torch.from_numpy(batch).to(dev), lens)
    S_w = enc.shape[1]
    abs_len = torch.floor(lens * S_w)
    bias = torch.where(torch.arange(S_max, device=dev)[None, :]
                       > abs_len[:, None], -1e9, 0.0)
    enc = torch.nn.functional.pad(enc, (0, 0, 0, S_max - S_w))
    cache = model.init_decode_cache(enc, 3 + cap, bias,
                                    cache_dtype=eng.searcher.kv_cache_dtype)
    sp = eng.tokenizer
    prompt = torch.tensor([[eng.searcher.bos_token,
                            sp.encode_as_ids(f"[{src}]")[-1],
                            sp.encode_as_ids(f"[{tgt}]")[-1]]], device=dev)
    hidden = model.decode_window(prompt, 0, cache)
    seq_lin, eos = eng.searcher.seq_lin, eng.searcher.config.eos_index
    tok = int(torch.argmax(seq_lin(hidden[:, -1]), dim=-1))
    budget = min(int(abs_len.item()) + 1, cap)
    out, pos = [], 3
    while tok != eos and len(out) < budget:
        out.append(tok)
        if len(out) >= budget:
            break
        hidden = model.decode_step(torch.tensor([tok], device=dev), pos,
                                   cache)
        tok = int(torch.argmax(seq_lin(hidden), dim=-1))
        pos += 1
    return out


def one_at_a_time(cont, reqs):
    """Each request submitted alone, after the previous one's answer
    (each admitted as its own group of one); the slot loop's tokens."""
    tokens, finish = {}, cont._finish

    def record(s):
        slot = cont._slots[s]
        tokens[id(slot.req.future)] = list(slot.tokens)
        finish(s)

    cont._finish = record
    out = []
    try:
        for wav, task in reqs:
            fut = cont.submit(wav, task)
            fut.result(timeout=300)
            out.append(tokens[id(fut)])
    finally:
        cont._finish = finish
    return out


def serve_phase(torch, kernels, K, smi: str, root: str, profile: bool):
    """The port's serving front on the recipe's experiment: the batch front
    through every route and under load, the continuous front against the
    sequential oracle, under load and with protocol finalization."""
    from stac_st_tpu_torch.recipes import serve
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.serving_continuous import ContinuousBatchingEngine
    from stac_st_tpu_torch.serving_http import STHttpServer

    sync = torch.cuda.synchronize
    exp = os.path.join(root, "exp")
    rec = {"phase": "serve", "gpu": smi, "experiment": "phase recipe's",
           "serve_args": SERVE_ARGS, "slots": SLOTS, "chunk": CHUNK}
    t_phase = time.perf_counter()

    def since(snap):
        return {k: v - snap.get(k, 0) for k, v in kernels.launches.items()
                if v != snap.get(k, 0)}

    kernels.reset_launches()
    refs = Refs(K).__enter__()
    try:
        # ---- the batch front, built as the serve recipe builds it
        t = time.perf_counter()
        front, server = serve.start_servers(
            serve.build_parser().parse_args([exp, *SERVE_ARGS]))
        sync()
        rec["start_and_warmup_s"] = time.perf_counter() - t
        eng, port = front.engine, server.port
        utts, pool, conv = serve_audio(eng, root)
        rec["conversation_s"] = len(conv) / SR
        try:
            wav = pool[0][0]
            body, pcm = pcm16_body(wav), to_pcm16(wav)
            routes, answers = {}, {}
            t = time.perf_counter()
            for path, want in (
                    ("/v1/translate", lambda: {"text": eng.translate(
                        [pcm])[0]}),
                    ("/v1/transcribe", lambda: {"text": eng.transcribe(
                        [pcm])[0]}),
                    ("/v1/transcribe_translate", lambda: dict(zip(
                        ("transcription", "translation"),
                        (x[0] for x in eng.transcribe_and_translate(
                            [pcm]))))),
                    ("/v1/speaker_turns", lambda: {
                        "events": eng.speaker_turns([pcm])[0]}),
                    ("/v1/long_form", lambda: json.loads(json.dumps(
                        eng.long_form(to_pcm16(conv)))))):
                code, got = http_post(
                    port, path, pcm16_body(conv) if "long" in path else body)
                check(code == 200, f"{path}: HTTP {code}")
                check(got == want(), f"{path}: differs from the engine's "
                      "direct call")
                routes[path], answers[path] = "equal", got
            check(http_get(port, "/healthz") == (200, {"status": "ok"}),
                  "/healthz")
            code, stats = http_get(port, "/stats")
            check(code == 200 and stats["requests"] == 5, f"/stats {stats}")
            rec["routes"] = routes
            rec["routes_s"] = time.perf_counter() - t
            lf = answers["/v1/long_form"]
            rec["long_form"] = {
                "segments": len(lf["segments"]),
                "rttm_lines": {k: len(v) for k, v in lf["rttm"].items()}}
            check(len(lf["segments"]) >= 4, f"long_form segments {lf}")
            snap = dict(kernels.launches)
            with Stages(eng, ("_texts",)) as calls, \
                    Stages(eng.searcher, ("search",)) as searches:
                rec["batch_load"] = load_window(port, pool)
            wall = rec["batch_load"]["wall_s"]
            rec["batch_load"]["stages"] = {**calls.report(wall),
                                           **searches.report(wall)}
            rec["batch_load"]["front_stats"] = front.stats()
            rec["batch_load"]["batch_histogram"] = front.batch_histogram()
            if profile:
                rec["batch_profile"] = profile_call(
                    torch, partial(load_window, port, pool, 5.0), None,
                    "serve_batch", watch=("anc_split_kernel",
                                          "cross_split_kernel"))
            rec["batch_load"]["launches"] = since(snap)
            batch_launches = dict(kernels.launches)
        finally:
            server.close()
            front.close()
        for name in ("decode_self_attention_anc", "decode_cross_attention"):
            check(batch_launches.get(f"{name}/{SPLIT}", 0) > 0,
                  f"batch front launched no {name}/{SPLIT}")

        # ---- the continuous front on the same engine
        snap = dict(kernels.launches)
        cont = ContinuousBatchingEngine(eng, slots=SLOTS, chunk=CHUNK)
        server = STHttpServer(cont, port=0).start()
        try:
            t = time.perf_counter()
            rec["continuous_warmup_shapes"] = cont.warmup()
            sync()
            rec["continuous_warmup_s"] = time.perf_counter() - t
            reqs = [(pool[i][0], ("translate", "transcribe")[i % 2])
                    for i in range(N_EXACT)]
            t = time.perf_counter()
            got = one_at_a_time(cont, reqs)
            want = [greedy_oracle(eng, cont._S_max, cont.cap, w, "es",
                                  "en" if task == "translate" else "es")
                    for w, task in reqs]
            rec["bf16_oracle_agreement"] = {
                "equal": sum(a == b for a, b in zip(got, want)),
                "of": len(reqs)}
            rec["oracle_s"] = time.perf_counter() - t
            with Stages(cont, ("_admit_batch", "_step_chunk")) as stages:
                rec["continuous_load"] = load_window(server.port, pool)
            rec["continuous_load"]["stages"] = stages.report(
                rec["continuous_load"]["wall_s"])
            if profile:
                rec["continuous_profile"] = profile_call(
                    torch, partial(load_window, server.port, pool, 5.0),
                    None, "serve_continuous",
                    watch=("self_split_rows_kernel", "cross_split_kernel"))
            stats = cont.stats()
            rec["continuous_load"].update({
                "utilization": cont.utilization(), "stats": stats,
                "launches": since(snap)})
        finally:
            server.close()
            cont.close()
        cont_launches = since(snap)
        name = "decode_self_attention"
        check(cont_launches.get(f"{name}/rows/{SPLIT}", 0) > 0
              and cont_launches.get(f"{name}/rows/{SPLIT}")
              == cont_launches.get(f"{name}/rows"),
              f"slot loop's ragged self launches on {SPLIT}: {cont_launches}")
        check(cont_launches.get(f"decode_cross_attention/{SPLIT}", 0) > 0,
              f"slot loop's cross launches: {cont_launches}")

        # ---- protocol finalization: close() right after submitting
        t = time.perf_counter()
        drafts = []
        cont = ContinuousBatchingEngine(eng, slots=SLOTS, chunk=CHUNK,
                                        protocol_finalize=True)
        futs = [cont.submit(pool[i][0], on_draft=drafts.append)
                for i in range(N_FINAL)]
        cont.close()
        finals = [f.result(timeout=0) for f in futs]
        stats = cont.stats()
        check(stats["finalized"] == N_FINAL and len(drafts) == N_FINAL
              and all(isinstance(x, str) for x in finals),
              f"protocol finalize: {stats}")
        direct = eng.translate([pool[i][0] for i in range(N_FINAL)])
        rec["protocol_finalize"] = {
            "requests": N_FINAL, "finalized": stats["finalized"],
            "draft_exact": stats["draft_exact"],
            "equal_to_one_translate_call": sum(
                a == b for a, b in zip(finals, direct)),
            "s": time.perf_counter() - t}
        check(refs.cuda_calls == 0,
              f"{refs.cuda_calls} plain-version calls on CUDA tensors")
    finally:
        refs.__exit__()
    rec["launches"] = dict(kernels.launches)

    # ---- exact tokens: an fp32 engine of the experiment (TF32 off)
    t = time.perf_counter()
    eng32 = STEngine.from_saved_experiment(exp, device="cuda", bf16=False,
                                           pad_batch_rows=(4, 16))
    snap = dict(kernels.launches)
    cont = ContinuousBatchingEngine(eng32, slots=SLOTS, chunk=CHUNK)
    try:
        reqs = [(pool[i][0], ("translate", "transcribe")[i % 2])
                for i in range(N_EXACT)]
        got = one_at_a_time(cont, reqs)
    finally:
        cont.close()
    want = [greedy_oracle(eng32, cont._S_max, cont.cap, w, "es",
                          "en" if task == "translate" else "es")
            for w, task in reqs]
    fp32 = since(snap)
    check(got == want, "fp32 continuous tokens differ from the oracle: "
          f"{[i for i, (a, b) in enumerate(zip(got, want)) if a != b]}")
    check(fp32.get("decode_self_attention/rows/simt", 0) > 0
          and fp32.get("decode_self_attention/simt", 0) > 0,
          f"fp32 ragged (slot loop) and scalar (oracle) self: {fp32}")
    rec["fp32_exact"] = {"requests": N_EXACT, "equal": len(got),
                         "tokens": [len(x) for x in got],
                         "launches": fp32, "s": time.perf_counter() - t}

    # ---- the slot loop with the int8 cache: an fp32 engine, exact against
    # the sequential int8 greedy oracle, then the same load for INT8_LOAD_S
    t = time.perf_counter()
    eng8 = STEngine.from_saved_experiment(exp, device="cuda", bf16=False,
                                          pad_batch_rows=(4, 16),
                                          kv_cache_dtype="int8")
    snap = dict(kernels.launches)
    cont = ContinuousBatchingEngine(eng8, slots=SLOTS, chunk=CHUNK)
    server = STHttpServer(cont, port=0).start()
    try:
        got = one_at_a_time(cont, reqs)
        want = [greedy_oracle(eng8, cont._S_max, cont.cap, w, "es",
                              "en" if task == "translate" else "es")
                for w, task in reqs]
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        check(not bad, f"int8 continuous tokens differ from the oracle: "
              f"requests {bad}")
        load = load_window(server.port, pool, INT8_LOAD_S)
    finally:
        server.close()
        cont.close()
    i8 = since(snap)
    name = "decode_self_attention_int8"
    check(i8.get(f"{name}/rows", 0) > 0 and i8.get(name, 0)
          > i8[f"{name}/rows"] and i8.get("decode_cross_attention_int8", 0)
          > 0 and not i8.get("decode_self_attention/rows", 0),
          f"int8 slot loop: ragged and scalar int8 self, int8 cross: {i8}")
    check(i8.get(f"{name}/rows/simt", 0) == i8[f"{name}/rows"]
          and i8.get("decode_cross_attention_int8/simt", 0)
          == i8["decode_cross_attention_int8"],
          f"fp32 int8 slot loop on simt: {i8}")
    rec["int8_continuous"] = {
        "requests": N_EXACT, "equal": len(got),
        "tokens": [len(x) for x in got], "load": load, "launches": i8,
        "s": time.perf_counter() - t}

    # ---- the bf16 slot loop with the int8 cache, as `recipes.serve
    # --continuous --kv-cache-dtype int8` builds it, under the same load
    t = time.perf_counter()
    snap = dict(kernels.launches)
    front, server = serve.start_servers(serve.build_parser().parse_args(
        [exp, *SERVE_ARGS, "--continuous", "--slots", str(SLOTS), "--chunk",
         str(CHUNK), "--kv-cache-dtype", "int8"]))
    try:
        warm_s = time.perf_counter() - t
        snap_load = dict(kernels.launches)
        load = load_window(server.port, pool, INT8_BF16_LOAD_S)
        load["launches"] = since(snap_load)
        load["utilization"] = front.utilization()
    finally:
        server.close()
        front.close()
    b8 = since(snap)
    check(b8.get(f"{name}/rows/{SPLIT}", 0) > 0
          and b8.get(f"{name}/rows/{SPLIT}") == b8.get(f"{name}/rows")
          and b8.get(f"decode_cross_attention_int8/{SPLIT}", 0) > 0
          and b8.get(f"decode_cross_attention_int8/{SPLIT}")
          == b8.get("decode_cross_attention_int8")
          and not b8.get("decode_self_attention/rows", 0),
          f"bf16 int8 slot loop: ragged int8 self and int8 cross on "
          f"{SPLIT}: {b8}")
    fl = rec["continuous_load"]
    rec["bf16_int8_continuous"] = {
        "start_and_warmup_s": warm_s, "load": load, "launches": b8,
        "bf16_float_cache": {"rtfx": fl["rtfx"],
                             "utilization": fl["utilization"],
                             "window_s": fl["window_s"]},
        "s": time.perf_counter() - t}
    for extra in (i8, b8):
        rec["launches"] = {k: rec["launches"].get(k, 0) + extra.get(k, 0)
                           for k in set(rec["launches"]) | set(extra)}
    rec["phase_s"] = time.perf_counter() - t_phase
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


# ------------------------------------------------------------ search options
# phase search_options: the serving configuration's search (beam 10, eos
# threshold 1.5, length normalization, temperature 1.15, 192 tokens) with
# each of the searcher's options, at the flagship preset, in a 10 s bucket
# (251 encoder frames: the kernel phase's shapes)
OPT_BUCKET = (10.0,)
CTC_WEIGHT, LM_WEIGHT, TIER, EOS_BOOST = 0.3, 0.3, 32, 12.0
CTC_K, V_FLAG = BEAM + 1, 5000
# the CTC kernel against its plain version, relative to max(1, |plain|):
# both take the same fp32 operations in the same order, but exp and log1p
# differ by an ulp between the card's and PyTorch's implementations, and
# the psi sum is taken in another order; 251 frames of such steps
CTC_TOL = 1e-4
NEG_CLASS = -1e8  # the -1e9 class of the recursion (ulp 64 there)
# the long case's frames: beyond the earlier designs' cap of 4,096 (48 KB
# of shared memory for a row's terms), 168 s of audio at 40 ms a frame
CTC_LONG_T = 4200
MASK_SECONDS = tuple(float(s) for s in np.linspace(2.0, 10.0, B))
CPU_SECONDS, CPU_TOKENS, CPU_TIER = (4.0, 2.5), 24, 8


def options_engine(mods, **kw):
    """main_path's engine (bf16, beam 10, 192 tokens, PCM16) with the
    10 s bucket."""
    return engine(mods, "cuda", bf16=True, beam_size=BEAM,
                  max_decode_tokens=192, transfer_dtype="int16",
                  bucket_seconds=OPT_BUCKET, **kw)


def ctc_texts(torch, eng, wavs, prompts):
    """Joint CTC/attention decoding through the searcher's API, as
    ``STEngine`` groups and encodes: per bucket one encoder pass, the CTC
    head's log-posteriors (log_softmax of ctc_lin, fp32), one search over
    the prompts (``call_multi``). texts[p][i]."""
    out = [[""] * len(wavs) for _ in prompts]
    with torch.inference_mode():
        for idx, batch, lens in eng._prepare(wavs):
            enc = eng._encode(batch, lens)
            ctc = torch.log_softmax(eng._ctc_lin(enc).float(), dim=-1)
            for p, (hyps, _) in enumerate(eng.searcher.call_multi(
                    enc, lens, prompts=prompts, ctc_log_probs=ctc)):
                for row, i in enumerate(idx):
                    out[p][i] = eng.tokenizer.decode_ids(hyps[row])
    return out


def decode_launches(launches, steps: int, kv) -> dict:
    """The decode kernels a beam-10 search of ``steps`` decode steps must
    launch (6 layers x (3 prompt + steps), every one on split): anc and
    cross with the float cache, the int8 self and cross with the int8
    cache; and the launched ones, to compare."""
    names = (("decode_self_attention_int8", "decode_cross_attention_int8")
             if kv else ("decode_self_attention_anc",
                         "decode_cross_attention"))
    per = 6 * (3 + steps)
    want = {f"{n}{v}": per for n in names for v in ("", f"/{SPLIT}")}
    got = {k: c for k, c in launches.items() if k.startswith("decode_")}
    return {"want": want, "got": got, "exact": got == want}


class CrossBias:
    """Counts the decoder's cross-attention calls with and without an
    encoder bias while active (wraps the two names ``models.transformer``
    calls; the kernels' launch counts are untouched)."""

    NAMES = ("decode_cross_attention", "decode_cross_attention_int8")

    def __enter__(self):
        import stac_st_tpu_torch.models.transformer as T

        self.T, self.saved, self.biased, self.unbiased = T, {}, 0, 0
        for n in self.NAMES:
            fn = self.saved[n] = getattr(T, n)

            def counted(*args, _fn=fn):
                if args[-2] is None:  # (..., bias, beam)
                    self.unbiased += 1
                else:
                    self.biased += 1
                return _fn(*args)

            setattr(T, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.T, n, fn)


def script_lm(torch, device, seed: int = 3, dim: int = 64):
    """A small seeded stateful LM written here: logits = tanh(E[token] +
    P[previous token]) W, its state the token fed (B·beam rows, so the
    search must gather it on every reorder). (step, init, params)."""
    gen = torch.Generator().manual_seed(seed)
    params = {k: (torch.randn(shape, generator=gen) * sc).to(device)
              for k, shape, sc in (("cur", (V_FLAG, dim), 1.0),
                                   ("prev", (V_FLAG, dim), 1.0),
                                   ("out", (dim, V_FLAG), 3.0 / dim ** 0.5))}

    def step(p, tokens, position, state):
        return torch.tanh(p["cur"][tokens] + p["prev"][state]) @ p["out"], \
            tokens

    def init(p, bb):
        return torch.ones((bb,), dtype=torch.long, device=p["out"].device)

    return step, init, params


def _ctc_err(got, want):
    """Largest |got - want| / max(1, |want|) over the entries outside the
    -1e9 class, and whether the class is the same on both sides."""
    neg = want <= NEG_CLASS
    same_class = bool(((got <= NEG_CLASS) == neg).all())
    rel = ((got - want).abs() / want.abs().clamp(min=1.0))[~neg]
    return (float(rel.max()) if rel.numel() else 0.0), same_class


def _ctc_inputs(torch, g, b, beam, T, K, make_lens):
    """Posteriors (b, T, V_FLAG), the rows' lengths (``make_lens(g)``) and
    b x beam rows, half of them on the empty prefix and half mid-prefix
    (state from four scores and selects on the card), eos, blank and the
    row's last label among K candidates."""
    from stac_st_tpu_torch.decoding import ctc_prefix as CP

    bb = b * beam
    lp = torch.log_softmax(3.0 * torch.randn((b, T, V_FLAG), generator=g),
                           dim=-1).to("cuda")
    lens = make_lens(g).to("cuda")
    state = CP.ctc_prefix_init(lp, 0, beam)
    mid = state
    for _ in range(4):
        cand = torch.randint(3, V_FLAG, (bb, K), generator=g).to("cuda")
        _, cs, cid = CP.ctc_prefix_score_all(mid, lp, lens, 0, 2, cand, beam)
        mid = CP.ctc_prefix_select(cs, cid, torch.randint(
            0, K, (bb,), generator=g).to("cuda"))
    odd = (torch.arange(bb, device="cuda") % 2 == 1)
    r_nb = torch.where(odd[:, None], mid.r_nb, state.r_nb).contiguous()
    r_b = torch.where(odd[:, None], mid.r_b, state.r_b).contiguous()
    last = torch.where(odd, mid.last, state.last).contiguous()
    cand = torch.randint(3, V_FLAG, (bb, K), generator=g).to("cuda")
    cand[:, 0], cand[:, 1] = 2, 0  # eos, blank
    cand[:, 2] = torch.where(last >= 0, last, cand[:, 2])
    return lp, r_nb, r_b, last, cand.contiguous(), lens


def _ctc_case(torch, kernels, timer, key, args):
    """One ctc_prefix_score case against the plain version: the wrapper
    launches (counted, no plain fallback), bitwise over two launches,
    within CTC_TOL outside the -1e9 class, the class in the same places;
    µs, the plain version's, the bound."""
    from stac_st_tpu_torch.ops.kernels import ctc_prefix as KC

    lp, r_nb, _, _, c, _, _, _, beam = args
    b, T = lp.shape[:2]
    run = partial(KC.ctc_prefix_score, *args)
    plain = partial(KC.ctc_prefix_score_ref, *args)
    before = kernels.launches.get("ctc_prefix_score", 0)
    one, two = run(), run()
    torch.cuda.synchronize()
    launched = kernels.launches.get("ctc_prefix_score", 0) - before
    check(launched == 2, f"ctc_prefix_score {key}: {launched} launches "
          "counted for two calls")
    check(all(torch.equal(x, y) for x, y in zip(one, two)),
          f"ctc_prefix_score {key}: not bitwise over two launches")
    want = plain()
    errs = {}
    for label, x, w in zip(("scores", "r_nb", "r_b"), one, want):
        err, same = _ctc_err(x, w)
        check(same, f"ctc_prefix_score {key} {label}: -1e9 class differs")
        check(err <= CTC_TOL, f"ctc_prefix_score {key} {label}: "
              f"relative err {err} > {CTC_TOL}")
        errs[label] = err
    rows = r_nb.shape[0]
    K = V_FLAG if c is None else c.shape[1]
    # bytes this run's data needs: the distinct (utterance, token)
    # posterior columns over T (the candidates and blank), the prefix
    # state, the indices; the scores and the (rows, K, T) state written
    cols = sum(int(torch.unique(torch.cat([
        (torch.arange(V_FLAG, device="cuda") if c is None
         else c[u * beam:(u + 1) * beam].reshape(-1)),
        torch.zeros(1, dtype=torch.long, device="cuda")])).numel())
        for u in range(b))
    nbytes = (cols * T * 4 + 2 * rows * T * 4 + rows * 8 * (2 + (
        0 if c is None else K)) + rows * K * 4 + 2 * rows * K * T * 4)
    # a lane-frame: three logaddexps (phi, nb, b) and the psi term,
    # about 20 operations
    b_ms, b_by = bound_ms(nbytes, 20.0 * rows * K * T, "float32")
    return {"rows": rows, "K": K, "T": T, "beam": beam, "rel_err": errs,
            "max_abs_err": max(float((x - w).abs()[w > NEG_CLASS].max())
                               for x, w in zip(one, want)),
            "bitwise_repeatable": True, "launches_counted": launched,
            "ms": timer.ms(run),
            "plain_ms": timer.ms(plain, n=3 if T < CTC_LONG_T else 1),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "library_ms": None,
            "library": "none: no PyTorch call scores CTC prefixes of "
                       "candidate continuations (F.ctc_loss is a "
                       "full-label forward)",
            "host_us": host_us(torch, run)}


def ctc_kernel_cases(torch, kernels, timer):
    """ctc_prefix_score (v3, ctc_prefix_kernel) against its plain version
    on the card: the flagship joint search (B16 x beam 10 = 160 rows, K 11
    candidates, T 251 frames, V 5000), half the rows on the empty prefix
    and half mid-prefix, input lengths 126-251, eos, blank and the row's
    last label among the candidates; the full-vocabulary mode at B2 x beam
    1; and beyond the earlier designs' 4,096-frame cap, T 4,200 at B2 x
    beam 3, K 4, lengths below T. Each case as _ctc_case checks it; ptxas registers and
    spills."""
    g = torch.Generator(device="cpu").manual_seed(13)
    rec = {"phase": "kernel", "name": "ctc_prefix_score",
           "kernel": "ctc_prefix_kernel",
           "registers": registers(kernels.build_logs["ctc_prefix"],
                                  "ctc_prefix_kernel"),
           "spills": spills(kernels.build_logs["ctc_prefix"],
                            "ctc_prefix_kernel")}
    check(len(rec["spills"]) == 1 and not any(
        sum(v) for v in rec["spills"].values()),
        f"ctc_prefix_kernel spills: {rec['spills']}")
    BB = B * BEAM
    lp, r_nb, r_b, last, cand, lens = _ctc_inputs(
        torch, g, B, BEAM, S_ENC, CTC_K,
        lambda g: 126 + torch.randperm(BB, generator=g) * 125 // (BB - 1))
    for key, b, beam, c, rows_ in (
            ("joint", B, BEAM, cand, slice(None)),
            ("full_vocabulary", 2, 1, None, slice(0, 2))):
        rec[key] = _ctc_case(torch, kernels, timer, key, (
            lp[:b].contiguous(), r_nb[rows_].contiguous(),
            r_b[rows_].contiguous(), last[rows_].contiguous(), c,
            lens[rows_].contiguous(), 0, 2, beam))
    del lp
    g = torch.Generator(device="cpu").manual_seed(17)
    T = CTC_LONG_T
    lp, r_nb, r_b, last, cand, lens = _ctc_inputs(
        torch, g, 2, 3, T, 4, lambda g: torch.tensor(
            [T - 7, T - 1000, T - 1, T - 333, T - 2047, T - 64]))
    rec["long"] = _ctc_case(torch, kernels, timer, "long",
                            (lp, r_nb, r_b, last, cand, lens, 0, 2, 3))
    rec["timer_floor_ms"] = timer.floor_ms()
    emit(rec)
    return rec


def cross_bias_cases(torch, K, timer):
    """The two cross kernels (bf16, split) with the padding bias the mask
    phase's batch gives them, B16 x beam 10 x 251, against their plain
    versions (the float one with its SDPA yardstick under the same key
    mask, the int8 one beside the float kernel on the dequantized
    values)."""
    g = torch.Generator(device="cpu").manual_seed(14)
    bf, BB = torch.bfloat16, B * BEAM
    keep = [math.floor(s / OPT_BUCKET[0] * S_ENC) for s in MASK_SECONDS]
    bias = torch.where(torch.arange(S_ENC, device="cuda")[None, :]
                       > torch.tensor(keep, device="cuda")[:, None],
                       -1e9, 0.0).float().contiguous()
    vis = [min(k + 1, S_ENC) for k in keep]
    q, kT, v = ((torch.randn(shape, generator=g) * sc).to("cuda", bf)
                for shape, sc in (((BB, H, DH), 1 / 8),
                                  ((B, H, DH, S_ENC), 1),
                                  ((B, H, S_ENC, DH), 1)))
    out = {"visible_frames": vis}
    out["decode_cross_attention"] = _timed_case(
        torch, timer, "decode_cross_attention", "cross with the mask",
        partial(K.decode_cross_attention, q, kT, v, bias, BEAM),
        partial(K.decode_cross_attention_ref, q, kT, v, bias, BEAM),
        (2 * BB * H * DH + 2 * H * sum(vis) * DH) * 2 + B * S_ENC * 4,
        4.0 * BEAM * H * sum(vis) * DH,
        lib=lambda want: (*_cross_lib(q, kT, v, BEAM, want)[:4],
                          (bias == 0)[:, None, None, :]))
    kq, ks = _int8_like(torch, torch.randn((B, H, DH, S_ENC), generator=g),
                        2)
    vq, vs = _int8_like(torch, torch.randn((B, H, S_ENC, DH), generator=g),
                        3)
    vs = vs.transpose(2, 3).contiguous()
    q8 = torch.randn((BB, H, DH), generator=g).to("cuda", bf)
    kf = (kq.float() * ks).to(bf).contiguous()
    vf = (vq.float() * vs.transpose(2, 3)).to(bf).contiguous()
    out["decode_cross_attention_int8"] = _int8_case(
        torch, K, timer, "cross int8 with the mask",
        partial(K.decode_cross_attention_int8, q8, kq, vq, ks, vs, bias,
                BEAM),
        partial(K.decode_cross_attention_int8_ref, q8, kq, vq, ks, vs, bias,
                BEAM),
        partial(K.decode_cross_attention, (q8.float() / 8).to(bf), kf, vf,
                bias, BEAM),
        2 * BB * H * DH * 2 + H * sum(vis) * (2 * DH + 8) + B * S_ENC * 4,
        4.0 * BEAM * H * sum(vis) * DH, "bfloat16",
        "decode_cross_attention_int8")
    return out


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def joint_ctc_cases(torch, kernels, wavs, base, att_wall, profile):
    """Joint CTC/attention decoding (ctc_weight 0.3, the model's own CTC
    head) of main_path's batch: the float cache (anc mode), the same
    through call_multi with both prompts, and the int8 cache (gather
    mode); warm RTFx beside the attention-only search's, exact launch
    counts of each warm call (one ctc_prefix_score a decode step, the
    decode kernels 6 x (3 + steps), all split)."""
    audio_s = B * SECONDS
    out = {"attention_only_warm_rtfx": audio_s / att_wall}
    for label, kv, dual in (("float", None, False), ("dual", None, True),
                            ("int8", "int8", False)):
        eng = options_engine(flagship(0), kv_cache_dtype=kv)
        eng.searcher.config = eng.searcher.config._replace(
            ctc_weight=CTC_WEIGHT)
        prompts = ([eng._prompt("es", "es"), eng._prompt("es", "en")]
                   if dual else [eng._prompt("es", "en")])
        run = partial(ctc_texts, torch, eng, wavs, prompts)
        run()  # first call: set-up
        kernels.reset_launches()
        texts, wall = _timed(torch, run)
        launches = dict(kernels.launches)
        steps = launches.pop("ctc_prefix_score", 0)
        dec = decode_launches(launches, steps, kv)
        check(1 <= steps <= 192 and dec["exact"] and not launches.keys()
              - dec["got"].keys(),
              f"joint CTC {label}: {steps} CTC launches, decode "
              f"{dec['got']}, want {dec['want']}")
        check(all(len(t) == B and all(t) for t in texts),
              f"joint CTC {label}: one non-empty text per input")
        case = {"steps": steps, "ctc_prefix_score_launches": steps,
                "launches": {**launches, "ctc_prefix_score": steps},
                "warm_s": wall, "warm_rtfx": audio_s / wall,
                "rtfx_vs_attention_only": att_wall / wall,
                "texts_differ_from_attention_only": sum(
                    a != b for a, b in zip(texts[-1], base))}
        if profile and label == "float":
            case["profile"] = profile_call(
                torch, run, wall, "joint_ctc",
                watch=("ctc_prefix_kernel", "anc_split_kernel",
                       "cross_split_kernel"))
            case["profile"]["ctc_share_of_busy"] = (
                case["profile"]["watched"].get("ctc_prefix_kernel", {})
                .get("device_us", 0.0) / 1e6
                / case["profile"]["device_busy_s"])
        out[label] = case
        del eng
    return out


def mask_cases(torch, kernels):
    """mask_encoder_padding on 16 utterances of 2-10 s in the 10 s bucket
    (beam 10), the float cache (anc) and the int8 cache (gather): every
    cross call of the warm masked translate carries the bias, the launch
    counts are exact, and the texts against the unmasked ones (printed)."""
    rng = np.random.default_rng(6)
    wavs = [(rng.standard_normal(int(sec * SR)) * 3000)
            .clip(-32768, 32767).astype(np.int16) for sec in MASK_SECONDS]
    out = {"seconds": list(MASK_SECONDS)}
    for label, kv in (("float", None), ("int8", "int8")):
        eng = options_engine(flagship(0), kv_cache_dtype=kv)
        plain = eng.translate(wavs)
        eng.searcher.mask_encoder_padding = True
        eng.translate(wavs)  # first masked call
        kernels.reset_launches()
        with CrossBias() as watch:
            texts, wall = _timed(torch, partial(eng.translate, wavs))
        launches = dict(kernels.launches)
        cross = ("decode_cross_attention_int8" if kv
                 else "decode_cross_attention")
        n = launches.get(cross, 0)
        steps = n // 6 - 3
        dec = decode_launches(launches, steps, kv)
        check(n % 6 == 0 and 1 <= steps <= 192 and dec["exact"],
              f"mask {label}: decode {dec['got']}, want {dec['want']}")
        check(watch.unbiased == 0 and watch.biased == n,
              f"mask {label}: {watch.biased} cross calls with the bias, "
              f"{watch.unbiased} without, {n} launched")
        out[label] = {"steps": steps, "launches": launches,
                      "cross_calls_with_bias": watch.biased,
                      "warm_s": wall,
                      "rtfx": sum(MASK_SECONDS) / wall,
                      "texts_differ_from_unmasked": sum(
                          a != b for a, b in zip(texts, plain))}
        del eng
    return out


def lm_cases(torch, kernels, wavs, base):
    """Shallow LM fusion with the script's stateful LM on main_path's
    batch: lm_weight 0 gives the LM-free texts; at 0.3 (flagship width)
    the warm RTFx, exact decode launch counts and the texts that moved."""
    eng = options_engine(flagship(0))
    step, init, params = script_lm(torch, "cuda")
    eng.searcher.set_lm(step, init, params, lm_weight=0.0)
    zero = eng.translate(wavs)
    check(zero == base, "lm_weight 0: texts differ from the LM-free search")
    eng.searcher.set_lm(step, init, params, lm_weight=LM_WEIGHT)
    eng.translate(wavs)  # first call
    kernels.reset_launches()
    texts, wall = _timed(torch, partial(eng.translate, wavs))
    launches = dict(kernels.launches)
    n = launches.get("decode_cross_attention", 0)
    dec = decode_launches(launches, n // 6 - 3, None)
    check(n % 6 == 0 and dec["exact"],
          f"LM fusion: decode {dec['got']}, want {dec['want']}")
    return {"weight_0_equals_lm_free": True, "steps": n // 6 - 3,
            "launches": launches, "warm_s": wall,
            "warm_rtfx": B * SECONDS / wall,
            "texts_differ_from_lm_free": sum(
                a != b for a, b in zip(texts, base))}


def tier_cases(torch, wavs):
    """decode_tier 32 under the 192-token cap, on the flagship weights and
    on a copy whose seq_lin eos bias is raised by 12 (its searches settle
    at once): texts equal to the single pass, and which searches took the
    fast path (the tier pass settled every row)."""
    out = {"tier": TIER, "max_decode_tokens": 192}
    fast = 0
    for label, boost in (("flagship", 0.0), ("eos_biased", EOS_BOOST)):
        mods = flagship(0)
        with torch.no_grad():
            mods["seq_lin"].linear.bias[2] += boost
        eng = options_engine(mods)
        single, s_wall = _timed(torch, partial(eng.translate, wavs))
        single, s_wall = _timed(torch, partial(eng.translate, wavs))
        eng.searcher.decode_tier = TIER
        eng.translate(wavs)
        tiered, t_wall = _timed(torch, partial(eng.translate, wavs))
        settled = eng.searcher.last_tier_settled
        check(tiered == single, f"tier {label}: texts differ from the "
              "single pass")
        fast += bool(settled)
        out[label] = {"fast_path": settled, "single_s": s_wall,
                      "tiered_s": t_wall,
                      "tokens_per_utt": [len(t.split()) for t in tiered]}
        del eng
    check(out["eos_biased"]["fast_path"],
          "tier: the eos-biased searches did not settle at the tier")
    out["fast_path_searches"] = fast
    out["searches"] = 2
    return out


def options_card_vs_cpu(torch):
    """Each option in fp32 (TF32 off), full width and depth, the card
    against the CPU (the kernels' plain versions): B2 x 4 s and 2.5 s in a
    4 s bucket, beam 10, 24 tokens; joint CTC, LM fusion, the padding
    mask, decode_tier 8 (its rerun path). Texts (the token ids) equal."""
    rng = np.random.default_rng(2)
    wavs = [(0.1 * rng.standard_normal(int(sec * SR))).astype(np.float32)
            for sec in CPU_SECONDS]
    texts = {}
    for dev in ("cuda", "cpu"):
        eng = engine(flagship(1), dev, bf16=False, beam_size=BEAM,
                     max_decode_tokens=CPU_TOKENS,
                     bucket_seconds=(max(CPU_SECONDS),))
        s, got = eng.searcher, {}
        s.config = s.config._replace(ctc_weight=CTC_WEIGHT)
        got["joint_ctc"] = ctc_texts(torch, eng, wavs,
                                     [eng._prompt("es", "en")])[0]
        s.config = s.config._replace(ctc_weight=0.0)
        s.set_lm(*script_lm(torch, dev), lm_weight=LM_WEIGHT)
        got["lm"] = eng.translate(wavs)
        s.config = s.config._replace(lm_weight=0.0)
        s.mask_encoder_padding = True
        got["mask"] = eng.translate(wavs)
        s.mask_encoder_padding = False
        s.decode_tier = CPU_TIER
        got["tier"] = eng.translate(wavs)
        got["tier_fast_path"] = s.last_tier_settled
        texts[dev] = got
        del eng
    out = {"batch": len(wavs), "seconds": list(CPU_SECONDS),
           "tokens": CPU_TOKENS, "dtype": "float32"}
    for case in ("joint_ctc", "lm", "mask", "tier"):
        equal = texts["cuda"][case] == texts["cpu"][case]
        check(equal, f"card vs CPU {case}: {texts['cuda'][case]} != "
              f"{texts['cpu'][case]}")
        out[case] = {"tokens_equal": equal,
                     "tokens": [len(t.split()) for t in texts["cpu"][case]]}
    out["tier"]["fast_path"] = texts["cuda"]["tier_fast_path"]
    return out


def masked_speculative(torch):
    """SpeculativeSTEngine (the speculative phase's target and draft, k 6,
    64 tokens, fp32) with mask_encoder_padding on the target's searcher:
    each utterance's text equals the target's beam-1 masked translate of
    it; 3 s and 6.5 s, each padded to its 4 s and 8 s bucket."""
    from stac_st_tpu_torch.serving import SpeculativeSTEngine

    rng = np.random.default_rng(5)
    wavs = [(0.1 * rng.standard_normal(int(sec * SR))).astype(np.float32)
            for sec in (3.0, 6.5)]
    opts = dict(bf16=False, beam_size=1, max_decode_tokens=SPEC_TOKENS)
    target = engine(flagship(0), "cuda", **opts)
    unmasked = [target.translate([w])[0] for w in wavs]
    target.searcher.mask_encoder_padding = True
    draft = engine(flagship(7, enc=2, dec=2), "cuda", **opts)
    spec = SpeculativeSTEngine(target, draft, k=SPEC_K)
    with CrossBias() as watch:
        got, want, wall, stats = _spec_texts(torch, spec, target, wavs)
    check(got == want, f"masked speculative: {got} != {want}")
    check(watch.unbiased == 0 and watch.biased > 0,
          f"masked speculative: cross calls {watch.biased} with the bias, "
          f"{watch.unbiased} without")
    return {"equal_to_target_beam1": len(wavs), "of": len(wavs),
            "cross_calls_with_bias": watch.biased,
            "texts_differ_from_unmasked": sum(
                a != b for a, b in zip(want, unmasked)),
            "target_steps": sum(st["target_steps"] for st in stats),
            "wall_s": wall}


def search_options_phase(torch, kernels, K, timer, profile: bool):
    """Phase search_options (see the module docstring); returns its
    record, whose ``kernel`` line and joint CTC launches feed the kernels
    line."""
    t_phase = time.perf_counter()
    rec = {"phase": "search_options", "batch": B, "seconds": SECONDS,
           "beam": BEAM, "bucket_s": OPT_BUCKET[0],
           "ctc_weight": CTC_WEIGHT, "lm_weight": LM_WEIGHT}
    rec["kernel"] = ctc_kernel_cases(torch, kernels, timer)
    rec["cross_with_mask"] = cross_bias_cases(torch, K, timer)
    wavs = serving_wavs()
    eng = options_engine(flagship(0))
    eng.translate(wavs)
    base, att_wall = _timed(torch, partial(eng.translate, wavs))
    del eng
    rec["joint_ctc"] = joint_ctc_cases(torch, kernels, wavs, base, att_wall,
                                       profile)
    rec["mask"] = mask_cases(torch, kernels)
    rec["lm"] = lm_cases(torch, kernels, wavs, base)
    rec["tier"] = tier_cases(torch, wavs)
    rec["card_vs_cpu_fp32"] = options_card_vs_cpu(torch)
    rec["speculative_masked"] = masked_speculative(torch)
    rec["phase_s"] = time.perf_counter() - t_phase
    emit({k: v for k, v in rec.items() if k != "kernel"})
    return rec


# phase encoders: the JAX package's other model settings at the flagship
# width and depth, each from seed 0 (the canonical front end; the
# Conformer's kernel is the reference's 31)
ENCODER_MODELS = (
    ("post_ln", dict(normalize_before=False)),
    ("conformer_relpos", dict(encoder_module="conformer",
                              attention_type="RelPosMHAXL")),
    ("conformer_causal", dict(encoder_module="conformer", causal=True)),
)
ENC_TRAIN_STEPS = 3           # STTrainer steps a model, B32 x 15 s
ENC_SLOT_S = 5.0              # the post-LN slot loop's window (s)
ENC_REMAT_SEED = 4321
# fp32 encoder outputs, card vs CPU (TF32 off): 12 layers of d256 sums
# (and the Conformer's 31-tap convolutions) in other orders; each layer
# ends in a LayerNorm, so values are O(1)
ENC_ATOL = 1e-3


class _Calls:
    """Counts the calls of some methods of one object (instance
    attributes over the class's; ``restore`` removes them)."""

    def __init__(self, obj, names):
        self.obj, self.n = obj, {name: 0 for name in names}
        for name in names:
            setattr(obj, name, self._wrap(name, getattr(obj, name)))

    def _wrap(self, name, fn):
        def counted(*a, **kw):
            self.n[name] += 1
            return fn(*a, **kw)
        return counted

    def restore(self):
        for name in self.n:
            delattr(self.obj, name)


def _decode_want(names, calls: int) -> dict:
    """Every launch of ``calls`` decoder steps, 6 layers each, on split."""
    return {f"{n}{v}": 6 * calls for n in names for v in ("", f"/{SPLIT}")}


def _decode_got(launches) -> dict:
    return {k: v for k, v in launches.items() if k.startswith("decode_")}


def device_busy_ms(torch, fn) -> float:
    """The device busy time of one call of ``fn`` (ms): the union of its
    kernel and copy intervals in a torch.profiler trace of the device
    alone (no host events: tens of thousands of kernels read back in well
    under a second)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and \
                not ev.name().startswith("Activity Buffer"):
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    busy, end = 0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def _enc_serve(torch, kernels, name, mods, wavs) -> dict:
    """B16 x 10 s through STEngine (bf16, beam 10, 192 tokens, PCM16):
    the launches of a warm translate, exactly 6 x its decoder steps of anc
    and cross, all split; warm RTFx; the device busy time of the encoder
    pass of the same batch over that of the whole translate (two traces
    of the device alone)."""
    eng = engine(mods, "cuda", bf16=True, beam_size=BEAM,
                 max_decode_tokens=192, transfer_dtype="int16")
    eng.translate(wavs)  # first call: set-up
    calls = _Calls(eng._transformer, ("decode_step",))
    kernels.reset_launches()
    texts, wall = _timed(torch, partial(eng.translate, wavs))
    launches = dict(kernels.launches)
    calls.restore()
    steps = calls.n["decode_step"]
    want = _decode_want(("decode_self_attention_anc",
                         "decode_cross_attention"), steps)
    check(_decode_got(launches) == want,
          f"{name} serve: launches {launches}, want {want}")
    check(len(texts) == B and all(texts), f"{name}: one text per input")
    busy = device_busy_ms(torch, partial(eng.translate, wavs))
    (_, batch, lens), = eng._prepare(wavs)
    with torch.inference_mode():
        enc = device_busy_ms(torch, partial(eng._encode, batch, lens))
    return {"decoder_steps": steps, "launches": launches,
            "translate_warm_s": wall,
            "translate_warm_rtfx": B * SECONDS / wall,
            "translate_device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / 1e3 / wall,
            "encoder_device_busy_ms": enc,
            "encoder_share_of_device_time": enc / busy}, texts


def _enc_post_ln_decoder(torch, kernels, mods, settings, wavs,
                         bf16_texts) -> dict:
    """The post-LN decoder's other forms: a beam-1 translate of 2 x 10 s
    (scalar self, cross, 6 x its steps each, on split), a slot loop of 16
    slots (chunk 16) under ENC_SLOT_S s of requests (ragged self
    ``decode_self_attention/rows/split`` 6 x its ragged steps, cross 6 x
    its ragged steps and windows), and a translate with the int8 cache and
    int8 weights (int8 self and cross 6 x its steps, on split)."""
    from stac_st_tpu_torch.serving_continuous import ContinuousBatchingEngine

    out = {}
    eng1 = engine(mods, "cuda", bf16=True, beam_size=1,
                  max_decode_tokens=192, transfer_dtype="int16")
    eng1.translate(wavs[:2])
    calls = _Calls(eng1._transformer, ("decode_step",))
    kernels.reset_launches()
    texts, wall = _timed(torch, partial(eng1.translate, wavs[:2]))
    launches = dict(kernels.launches)
    calls.restore()
    want = _decode_want(("decode_self_attention", "decode_cross_attention"),
                        calls.n["decode_step"])
    check(_decode_got(launches) == want,
          f"post-LN beam 1: launches {launches}, want {want}")
    out["beam1"] = {"launches": launches, "translate_2x10s_s": wall,
                    "texts_nonempty": all(texts)}

    rng = np.random.default_rng(11)
    pool = [(rng.standard_normal(int(sec * SR)) * 3000).clip(
        -32768, 32767).astype(np.int16)
        for sec in rng.uniform(2.0, 10.0, 32)]
    cont = ContinuousBatchingEngine(eng1, slots=SLOTS, chunk=CHUNK)
    calls = _Calls(eng1._transformer, ("decode_step_rows", "decode_window"))
    kernels.reset_launches()
    served, t0 = 0, time.perf_counter()
    try:
        while time.perf_counter() - t0 < ENC_SLOT_S:
            futs = [cont.submit(w) for w in pool[:SLOTS]]
            check(all(isinstance(f.result(timeout=300), str) for f in futs),
                  "post-LN slot loop answers")
            served += sum(len(w) for w in pool[:SLOTS]) / SR
            pool = pool[SLOTS:] + pool[:SLOTS]
        util = cont.utilization()
    finally:
        cont.close()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    calls.restore()
    rows, windows = calls.n["decode_step_rows"], calls.n["decode_window"]
    # a ragged self launch counts under its name and under /rows
    want = {f"decode_self_attention{v}": 6 * rows
            for v in ("", f"/{SPLIT}", "/rows", f"/rows/{SPLIT}")}
    want.update(_decode_want(("decode_cross_attention",), rows + windows))
    check(_decode_got(launches) == want and rows > 0,
          f"post-LN slot loop: launches {launches}, want {want}")
    out["slot_loop"] = {"slots": SLOTS, "chunk": CHUNK, "window_s": wall,
                        "audio_s": served, "rtfx": served / wall,
                        "utilization": util, "ragged_steps": rows,
                        "windows": windows, "launches": launches}

    eng8 = engine(flagship(0, **settings), "cuda", bf16=True,
                  beam_size=BEAM, max_decode_tokens=192,
                  transfer_dtype="int16", kv_cache_dtype="int8",
                  weights_int8=True)
    eng8.translate(wavs)
    calls = _Calls(eng8._transformer, ("decode_step",))
    kernels.reset_launches()
    texts, wall = _timed(torch, partial(eng8.translate, wavs))
    launches = dict(kernels.launches)
    calls.restore()
    want = _decode_want(("decode_self_attention_int8",
                         "decode_cross_attention_int8"),
                        calls.n["decode_step"])
    check(_decode_got(launches) == want,
          f"post-LN int8: launches {launches}, want {want}")
    out["int8_cache_and_weights"] = {
        "launches": launches, "translate_warm_s": wall,
        "translate_warm_rtfx": B * SECONDS / wall,
        "texts_equal_bf16": sum(a == b for a, b in zip(texts, bf16_texts))}
    return out


def _enc_train(torch, kernels, name, settings) -> dict:
    """ENC_TRAIN_STEPS steps of B32 x 15 s (bf16, dropout 0.1) through
    STTrainer.fit: finite losses, flash launches a step by variant (18, or
    6 with RelPosMHAXL, whose encoder attention is plain), peak memory;
    then as many warm steps of the same batch, timed.
    With RelPosMHAXL also the remat check: loss_and_grad with the
    encoder recomputed in the backward against the same step without,
    bitwise (CTC weight 0 and cuDNN's deterministic algorithms, so that
    two runs of the step itself are bitwise equal; checked too)."""
    from stac_st_tpu_torch.training import step as pstep

    rng = np.random.default_rng(0)
    batch = _train_batch(rng, TB, int(SECONDS_TRAIN * SR), U_TRAIN)
    trainer = _trainer(torch, flagship(0, **settings), bf16=True)
    marks = []

    def copies():
        for _ in range(ENC_TRAIN_STEPS):
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
    losses = [float(x) for x in trainer.epoch_losses]
    check(len(losses) == ENC_TRAIN_STEPS and all(np.isfinite(losses)),
          f"{name} losses {losses}")
    per_step = 6 if settings.get("attention_type") == "RelPosMHAXL" else 18
    for kern in FLASH[1:]:
        n = per_step * ENC_TRAIN_STEPS
        check(launches.get(kern, 0) == n
              and launches.get(f"{kern}/{TC}", 0) == n,
              f"{name} {kern}: {launches}, want {n} on {TC}")
    check(not launches.get("flash_attention"), "no eval kernel in fit")
    # warm steps, timed after fit's (which pay the allocator's growth)
    state = trainer.state
    dev_batch = trainer._device_batch(batch)
    warm = [_timed(torch, partial(trainer.train_step, state, dev_batch,
                                  trainer.next_seed()))[1] * 1e3
            for _ in range(ENC_TRAIN_STEPS)]
    rec = {"steps": ENC_TRAIN_STEPS,
           "fit_step_ms": [x * 1e3 for x in np.diff(marks)],
           "warm_step_ms": warm, "warm_step_ms_median": float(
               np.median(warm)),
           "audio_s_per_s": TB * SECONDS_TRAIN * 1e3 / float(np.median(warm)),
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "flash_launches_a_step": per_step, "launches": launches}
    if settings.get("attention_type") != "RelPosMHAXL":
        return rec
    cfg = trainer.cfg._replace(ctc_weight=0.0)
    encoder = cfg.transformer.encoder
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grads, peaks, walls = [], [], []
    try:
        for remat in (False, True, False):
            encoder.remat = remat
            torch.cuda.reset_peak_memory_stats()
            (_, grad, _), wall = _timed(torch, partial(
                pstep.loss_and_grad, cfg, state, dev_batch, ENC_REMAT_SEED))
            grads.append(grad)
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            walls.append(wall * 1e3)
    finally:
        encoder.remat = False
        torch.backends.cudnn.deterministic = deterministic
    check(torch.equal(grads[0], grads[2]),
          "relpos step without remat: two runs not bitwise equal")
    check(torch.equal(grads[0], grads[1]),
          "relpos step: gradients with remat differ from those without")
    rec["remat"] = {"bitwise_equal": True, "ctc_weight": 0.0,
                    "peak_memory_gb": {"off": peaks[0], "on": peaks[1]},
                    "loss_and_grad_ms": {"off": walls[0], "on": walls[1]}}
    return rec


def _enc_card_vs_cpu(torch, name, settings) -> dict:
    """fp32 (TF32 off), seed 1, full width and depth, B2 x 4 s and 2.5 s in
    a 4 s bucket, beam 10, 24 tokens: encoder outputs within ENC_ATOL and
    the search's tokens equal, card against CPU."""
    rng = np.random.default_rng(2)
    wavs = [(0.1 * rng.standard_normal(int(sec * SR))).astype(np.float32)
            for sec in CPU_SECONDS]
    got = {}
    for dev in ("cuda", "cpu"):
        eng = engine(flagship(1, **settings), dev, bf16=False,
                     beam_size=BEAM, max_decode_tokens=CPU_TOKENS,
                     bucket_seconds=(max(CPU_SECONDS),))
        with torch.inference_mode():
            (_, batch, lens), = eng._prepare(wavs)
            enc = eng._encode(batch, lens).float().cpu()
        got[dev] = (enc, eng.translate(wavs))
        del eng
    err = (got["cuda"][0] - got["cpu"][0]).abs().max().item()
    check(err <= ENC_ATOL, f"{name} card vs CPU encoder: {err} > {ENC_ATOL}")
    check(got["cuda"][1] == got["cpu"][1],
          f"{name} card vs CPU tokens: {got['cuda'][1]} != {got['cpu'][1]}")
    return {"encoder_max_abs_err": err, "atol": ENC_ATOL,
            "tokens_equal": True,
            "tokens": [len(t.split()) for t in got["cpu"][1]]}


def _enc_recipe(torch, kernels, root: str) -> dict:
    """The relpos Conformer through the experiment path: the recipe's main
    on phase recipe's corpus (dev split, batches of at most 60 s, no
    accumulation, one epoch, no search or evaluation) with
    --encoder_module=conformer --attention_type=RelPosMHAXL; then
    STEngine.from_saved_experiment loads weights bitwise equal to the
    average of the kept checkpoints and translates 4 heldout utterances."""
    import contextlib

    from stac_st_tpu_torch.recipes import train_multitask as R
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.training.checkpoint import (
        Checkpointer,
        average_checkpoints,
    )

    out = os.path.join(root, "exp_conformer_relpos")
    args = [RECIPE_YAML, "--device=cuda", f"--data_folder={root}",
            f"--tokenizer_file={os.path.join(root, 'bpe.model')}",
            f"--output_folder={out}", "--train_splits=dev",
            "--dev_splits=dev", "--test_splits_4_translations=[]",
            "--test_splits_1_translations=[]", "--number_of_epochs=1",
            "--num_workers=1", "--no_eval=True", "--n_warmup_steps=10",
            "--grad_accumulation_factor=1", "--max_batch_len=60",
            "--turn=5", "--xt=6", "--encoder_module=conformer",
            "--attention_type=RelPosMHAXL"]
    t0 = time.perf_counter()
    with open(os.path.join(OUT_DIR, "recipe_conformer_log_cuda.txt"),
              "w") as log, contextlib.redirect_stdout(log):
        trainer = R.main(args)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    tr = trainer.cfg.transformer
    check(tr.encoder_module == "conformer"
          and tr.attention_type == "RelPosMHAXL"
          and type(tr.encoder).__name__ == "ConformerEncoder",
          "the recipe built a relpos Conformer")
    check(trainer.state.micro_step >= 2, f"{trainer.state.micro_step} steps")
    acc = Checkpointer(os.path.join(out, "save")).find_checkpoints(
        max_key="ACC")
    check(len(acc) >= 1, "a checkpoint kept")
    avg = average_checkpoints(acc, "model")
    eng = STEngine.from_saved_experiment(out, device="cuda", bf16=False)
    check(trees_equal(model_tree(eng._cnn, eng._transformer,
                                 eng.searcher.seq_lin, eng._ctc_lin), avg),
          "from_saved_experiment loads the average bitwise")
    check(type(eng._transformer.encoder).__name__ == "ConformerEncoder",
          "the reloaded engine runs the Conformer")
    with open(os.path.join(root, "heldout", "data-st.json")) as f:
        heldout = json.load(f)
    audio = [eng.load_audio(e["wav"].split()[0].replace("{data_root}", root))
             for e in list(heldout.values())[:4]]
    texts, wall = _timed(torch, partial(eng.translate, audio))
    check(len(texts) == 4 and all(isinstance(t, str) for t in texts),
          "the reloaded experiment translates")
    return {"overrides": args[1:], "main_s": main_s,
            "micro_steps": trainer.state.micro_step,
            "checkpoints": len(acc), "reload_bitwise": True,
            "translate_4_s": wall, "translations": texts[:2]}


def encoders_phase(torch, kernels, smi: str, root: str):
    """Phase encoders (see the module docstring): one JSON line a model;
    the recipe run of the relpos Conformer goes in its line."""
    wavs = serving_wavs()
    t_phase = time.perf_counter()
    recs = {}
    for name, settings in ENCODER_MODELS:
        rec = {"phase": "encoders", "model": name, "settings": settings,
               "gpu": smi, "batch": B, "seconds": SECONDS, "beam": BEAM}
        stages, t0 = {}, time.perf_counter()

        def stage(label):
            nonlocal t0
            stages[label] = time.perf_counter() - t0
            t0 = time.perf_counter()

        mods = flagship(0, **settings)
        stage("build")
        rec["serve"], texts = _enc_serve(torch, kernels, name, mods, wavs)
        stage("serve")
        if name == "post_ln":
            rec["post_ln_decoder"] = _enc_post_ln_decoder(
                torch, kernels, mods, settings, wavs, texts)
            stage("post_ln_decoder")
        del mods
        rec["train"] = _enc_train(torch, kernels, name, settings)
        stage("train")
        rec["card_vs_cpu_fp32"] = _enc_card_vs_cpu(torch, name, settings)
        stage("card_vs_cpu")
        if name == "conformer_relpos":
            rec["recipe"] = _enc_recipe(torch, kernels, root)
            stage("recipe")
        rec["stage_s"] = stages
        emit(rec)
        recs[name] = rec
    return {"models": recs, "phase_s": time.perf_counter() - t_phase}


# ------------------------------------------------------- data_parallel
# two ranks: nccl with a card each where there are two, else gloo with
# both ranks on cuda:0 (nccl refuses two ranks on one card)
DP_RANKS, DP_FP32_STEPS, DP_BF16_STEPS = 2, 2, 6
DP_SLOT_REQUESTS = 8


def dp_layout(torch):
    """(backend, cards, the serving mesh's devices)."""
    if torch.cuda.device_count() >= DP_RANKS:
        return "nccl", DP_RANKS, [f"cuda:{i}" for i in range(DP_RANKS)]
    return "gloo", 1, ["cuda:0"] * DP_RANKS


def _dp_trainer(torch, bf16: bool, dropout: float, count: int):
    """The train phase's trainer at the flagship width and depth, with
    ``data_parallel_count``."""
    trainer = _trainer(torch, flagship(0, dropout=dropout), bf16,
                       run_opts={"data_parallel_count": count})
    trainer.ensure_state()
    return trainer


def _dp_fp32_steps(torch, trainer, batch):
    """DP_FP32_STEPS steps of the global batch ``batch`` (dropout 0.1,
    CMVN update): each step's loss, reduced gradient and parameters."""
    from stac_st_tpu_torch.training import step as S

    dev = trainer._device_batch(batch)
    out = []
    for _ in range(DP_FP32_STEPS):
        m, g, cmvn = S.loss_and_grad(trainer.cfg, trainer.state, dev,
                                     trainer.next_seed(), True)
        trainer.tx.update(g, trainer.state.opt_state,
                          trainer.state.params.flat)
        trainer.state.cmvn = cmvn
        out.append((float(m["loss"]), g.detach().cpu(),
                    trainer.state.params.flat.detach().cpu().clone()))
    return out


def _dp_bf16_fit(torch, kernels, trainer, batch) -> dict:
    """DP_BF16_STEPS steps of the global batch through fit: each step's
    ms, the warm audio-s/s of the GLOBAL batch, the launches."""
    marks = []

    def copies():
        for _ in range(DP_BF16_STEPS):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield batch
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    kernels.reset_launches()
    trainer.fit([1], copies())
    launches = dict(kernels.launches)
    steps = np.diff(marks)
    warm = float(np.median(steps[2:]))
    losses = [float(x) for x in trainer.epoch_losses]
    check(len(losses) == DP_BF16_STEPS and all(np.isfinite(losses)),
          f"bf16 losses {losses}")
    for name in FLASH[1:]:
        n = 18 * DP_BF16_STEPS
        check(launches.get(name, 0) == n and launches.get(f"{name}/{TC}")
              == n, f"{name}: {launches} (want {n}, all {TC})")
    return {"step_ms": [x * 1e3 for x in steps], "warm_step_ms": warm * 1e3,
            "audio_s_per_s": TB * SECONDS_TRAIN / warm, "losses": losses,
            "launches": {k: v for k, v in launches.items()
                         if k.startswith("flash")}}


def _dp_recipe(root: str, out: str, backend: str, rank: int,
               sigterm: bool = False):
    """The recipe at its full width on phase recipe's dev split (batches of
    at most 60 s, no accumulation, CTC weight 0 so that CUDA's CTC backward
    and its atomics stay out, two epochs, the dual search in epoch 2); with
    ``sigterm``, rank 1 alone raises SIGTERM as its first step begins."""
    import contextlib
    import signal

    from stac_st_tpu_torch.recipes import train_multitask as R
    from stac_st_tpu_torch.training.trainer import STTrainer

    args = [RECIPE_YAML, "--device=cuda", f"--distributed_backend={backend}",
            f"--data_folder={root}",
            f"--tokenizer_file={os.path.join(root, 'bpe.model')}",
            f"--output_folder={out}", "--train_splits=dev",
            "--dev_splits=dev", "--test_splits_4_translations=[]",
            "--test_splits_1_translations=[]", "--number_of_epochs=2",
            "--valid_search_interval=2", "--num_workers=1",
            "--no_eval=True", "--n_warmup_steps=10", "--ctc_weight=0",
            "--grad_accumulation_factor=1", "--max_batch_len=60",
            "--turn=5", "--xt=6"]
    original = STTrainer.next_seed
    if sigterm and rank == 1:
        def next_seed(self):
            if not getattr(self, "_signalled", False):
                self._signalled = True
                signal.raise_signal(signal.SIGTERM)
            return original(self)
        STTrainer.next_seed = next_seed
    try:
        with open(f"{out}.rank{rank}.log", "w") as log, \
                contextlib.redirect_stdout(log):
            return R.main(args)
    finally:
        STTrainer.next_seed = original


def _dp_worker(rank: int, port: int, root: str, backend: str):
    """One rank of phase data_parallel: the fp32 steps, the bf16 fit, the
    flat gradient's all-reduce time, the recipe three times."""
    import torch
    import torch.distributed as dist

    from stac_st_tpu_torch.device import set_tf32
    from stac_st_tpu_torch.ops import kernels
    from stac_st_tpu_torch.parallel.distributed import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS),
                      LOCAL_RANK=str(rank if backend == "nccl" else 0),
                      LOCAL_WORLD_SIZE=str(DP_RANKS if backend == "nccl"
                                           else 1),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    check(init_distributed(backend), "joined the process group")
    set_tf32(False)
    res = {"device": str(torch.cuda.current_device())}
    batch = _train_batch(np.random.default_rng(0), TB,
                         int(SECONDS_TRAIN * SR), U_TRAIN)
    t0 = time.perf_counter()
    trainer = _dp_trainer(torch, False, 0.1, -1)
    res["local_rows"] = int(trainer._device_batch(batch)["sig"].shape[0])
    res["fp32"] = _dp_fp32_steps(torch, trainer, batch)
    del trainer
    torch.cuda.empty_cache()
    res["fp32_s"] = time.perf_counter() - t0
    trainer = _dp_trainer(torch, True, 0.1, DP_RANKS)
    res["bf16"] = _dp_bf16_fit(torch, kernels, trainer, batch)
    buf = torch.ones_like(trainer.state.params.flat)
    ev, wall = [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        trainer.dp.sum(buf)
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ev.append(a.elapsed_time(b))
    check(float(buf[0]) == float(DP_RANKS) ** 5, "all-reduce sums ranks")
    res["allreduce_ms"] = {"events": ev, "wall": wall,
                           "bytes": buf.numel() * 4}
    del trainer, buf
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    recipe = {}
    for name, out, sigterm in (("whole", "dp_whole", False),
                               ("cut", "dp_cut", True),
                               ("resumed", "dp_cut", False)):
        t0 = time.perf_counter()
        tr = _dp_recipe(root, os.path.join(root, out), backend, rank,
                        sigterm)
        torch.cuda.synchronize()
        recipe[name] = {"s": time.perf_counter() - t0,
                        "preempted": tr.preempted,
                        "micro_step": tr.state.micro_step,
                        "valid": tr.last_valid_stats,
                        "flat": tr.state.params.flat.detach().cpu()}
        del tr
    res["recipe"] = recipe
    torch.save(res, os.path.join(root, f"dp_rank{rank}.pt"))
    dist.destroy_process_group()


def _dp_train(torch, kernels, root: str, backend: str) -> dict:
    """The 1-rank references on this process, then the two ranks."""
    import socket

    import torch.multiprocessing as mp

    from stac_st_tpu_torch.training.checkpoint import Checkpointer

    batch = _train_batch(np.random.default_rng(0), TB,
                         int(SECONDS_TRAIN * SR), U_TRAIN)
    trainer = _dp_trainer(torch, False, 0.1, -1)
    one = _dp_fp32_steps(torch, trainer, batch)
    cnn = torch.zeros(one[0][1].numel(), dtype=torch.bool)
    for name, view in trainer.state.params.named(cnn).items():
        if name.startswith("CNN."):
            view.fill_(True)
    del trainer
    torch.cuda.empty_cache()
    trainer = _dp_trainer(torch, True, 0.1, -1)
    one_bf16 = _dp_bf16_fit(torch, kernels, trainer, batch)
    del trainer
    torch.cuda.empty_cache()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(_dp_worker, args=(port, root, backend), nprocs=DP_RANKS,
             join=True)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"dp_rank{r}.pt"),
                        weights_only=False) for r in range(DP_RANKS)]
    check(all(r["local_rows"] == TB // DP_RANKS for r in ranks),
          "each rank ships its half of the global batch")
    # fp32: the card_vs_cpu_train tolerances, both steps
    fp32 = {"loss_rel_err": [], "grad_rel_err": [], "cnn_grad_rel_err": [],
            "param_err_determined": [], "determined_share": []}
    sure = torch.ones_like(cnn)
    for (l1, g1, p1), (l2, g2, p2), (_, g3, p3) in zip(
            one, ranks[0]["fp32"], ranks[1]["fp32"]):
        check(torch.equal(p2, p3) and torch.equal(g2, g3),
              "the ranks hold one state")
        scale = float(g1.abs().max())
        gd = (g2 - g1).abs()
        # determined: |g| above the summation-order noise in every step
        # so far (an undetermined sign moves a parameter by 2 lr, which
        # Adam carries into the next step)
        sure &= g1.abs() > 1e-3 * scale
        fp32["loss_rel_err"].append(abs(l2 - l1) / abs(l1))
        fp32["grad_rel_err"].append(float(gd[~cnn].max()) / scale)
        fp32["cnn_grad_rel_err"].append(float(gd[cnn].max()) / scale)
        fp32["param_err_determined"].append(float((p2 - p1).abs()[sure]
                                                  .max()))
        fp32["determined_share"].append(float(sure.float().mean()))
    # the gradients of step 1, on the same parameters; step 2's are taken
    # where the step-1 updates differ by 2 lr on the undetermined entries
    check(max(fp32["loss_rel_err"]) <= 1e-5, f"fp32 2 ranks vs 1: {fp32}")
    check(fp32["grad_rel_err"][0] <= 1e-4, f"fp32 gradients: {fp32}")
    check(fp32["cnn_grad_rel_err"][0] <= 1e-3, f"fp32 CNN: {fp32}")
    check(max(fp32["param_err_determined"]) <= 1e-6, f"fp32 params {fp32}")
    # the recipe: a joint stop, the resume bitwise the uninterrupted run
    rec = {r: ranks[0]["recipe"][r] for r in ("whole", "cut", "resumed")}
    for r in ranks:
        check(r["recipe"]["cut"]["preempted"]
              and r["recipe"]["cut"]["micro_step"] == 2,
              f"joint stop after step 2: {r['recipe']['cut']}")
        check(not r["recipe"]["resumed"]["preempted"]
              and r["recipe"]["resumed"]["micro_step"]
              == r["recipe"]["whole"]["micro_step"],
              "the resumed run ends where the whole one ends")
        check(torch.equal(r["recipe"]["resumed"]["flat"],
                          r["recipe"]["whole"]["flat"]),
              "resumed parameters bitwise the uninterrupted run's")
        check(r["recipe"]["resumed"]["valid"] == r["recipe"]["whole"]["valid"]
              and "BLEU" in r["recipe"]["whole"]["valid"],
              "the same validation, with the search")
    ckpts = [Checkpointer(os.path.join(root, d, "save")).find_checkpoints(
        max_key="ACC") for d in ("dp_whole", "dp_cut")]
    check(len(ckpts[0]) == len(ckpts[1]) == 2, "an ACC checkpoint an epoch")
    newest = [max(c, key=lambda k: k.meta["epoch"]) for c in ckpts]
    check(trees_equal(newest[0].load("model"), newest[1].load("model"))
          and trees_equal(newest[0].load("opt_torch"),
                          newest[1].load("opt_torch")),
          "the final checkpoints are equal")
    return {
        "fp32": fp32,
        "bf16_one_rank": one_bf16,
        "bf16_ranks": [r["bf16"] for r in ranks],
        "allreduce_ms": [r["allreduce_ms"] for r in ranks],
        "recipe": {k: {kk: vv for kk, vv in v.items() if kk != "flat"}
                   for k, v in rec.items()},
        "rank_devices": [r["device"] for r in ranks],
        "ranks_s": ranks_s, "rank_fp32_s": [r["fp32_s"] for r in ranks],
    }


def _dp_row0_kernels(torch) -> dict:
    """The flash kernels on the second half of a batch with ``row0``
    against the whole batch's launch: bitwise (bf16 wgmma, fp32 simt),
    dropout 0.1."""
    from stac_st_tpu_torch.ops.kernels import train_attention as TA

    g = torch.Generator(device="cuda").manual_seed(3)
    b, half = 4, 2
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((b, T_ENC, H, DH), generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        bias = torch.zeros((b, T_ENC), device="cuda")
        o, lse = TA.flash_attention_train_fwd(q, k, v, bias, TRAIN_SEED,
                                              P_DROP)
        delta = TA.row_delta(do, o)
        full = (o, lse, TA.flash_attention_train_dq(
            q, k, v, bias, TRAIN_SEED, P_DROP, do, lse, delta),
            *TA.flash_attention_train_dkv(q, k, v, bias, TRAIN_SEED, P_DROP,
                                          do, lse, delta))
        hs = [t[half:].contiguous() for t in (q, k, v, bias, do)]
        o2, lse2 = TA.flash_attention_train_fwd(*hs[:4], TRAIN_SEED, P_DROP,
                                                row0=half)
        d2 = TA.row_delta(hs[4], o2)
        part = (o2, lse2, TA.flash_attention_train_dq(
            *hs[:4], TRAIN_SEED, P_DROP, hs[4], lse2, d2, row0=half),
            *TA.flash_attention_train_dkv(*hs[:4], TRAIN_SEED, P_DROP, hs[4],
                                          lse2, d2, row0=half))
        same = [torch.equal(f[half:], p) for f, p in zip(full, part)]
        check(all(same), f"row0 {dt}: {same}")
        other = TA.flash_attention_train_fwd(*hs[:4], TRAIN_SEED, P_DROP)[0]
        out[str(dt).split(".")[1]] = {
            "bitwise": True,
            "row0_moves_the_mask": not torch.equal(other, o2)}
        check(out[str(dt).split(".")[1]]["row0_moves_the_mask"],
              "row0 keys the mask")
    return out


def _dp_serve(torch, kernels, devices) -> dict:
    """STEngine over the mesh against one device, and the meshed slot
    loop against the sequential greedy oracle."""
    from stac_st_tpu_torch.parallel.mesh import make_mesh
    from stac_st_tpu_torch.serving_continuous import ContinuousBatchingEngine

    wavs = serving_wavs()
    audio_s = B * SECONDS
    mesh = make_mesh(DP_RANKS, devices)
    kw = dict(beam_size=BEAM, max_decode_tokens=192, transfer_dtype="int16")
    rec = {"mesh": [str(d) for d in mesh.devices]}
    e1 = engine(flagship(0), "cuda", bf16=False, **kw)
    em = engine(flagship(0), None, bf16=False, mesh=mesh, **kw)
    t1, s1 = _timed(torch, partial(e1.translate, wavs))
    tm, sm = _timed(torch, partial(em.translate, wavs))
    check(tm == t1, "fp32 meshed texts equal the one device's")
    rec["fp32"] = {"texts_equal": True, "one_s": s1, "mesh_s": sm}
    del e1
    # the slot loop over the mesh, fp32: requests one at a time (each
    # admitted alone, as the oracle encodes it), going round the shards
    reqs = [w[: int((1.5 + 0.5 * i) * SR)].astype(np.float32) / 32768.0
            for i, w in enumerate(wavs[:DP_SLOT_REQUESTS])]
    cont = ContinuousBatchingEngine(em, slots=16, chunk=16)
    take, used = cont._take_free, []
    cont._take_free = lambda: used.append(take()) or used[-1]
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        got = one_at_a_time(cont, [(w, "translate") for w in reqs])
    finally:
        cont.close()
    slot_s = time.perf_counter() - t0
    slot_launches = dict(kernels.launches)
    oracle = [greedy_oracle(em, cont._S_max, cont.cap, w, "es", "en")
              for w in reqs]
    shards = {s // cont._per for s in used}
    check(got == oracle, "the meshed slot loop is the greedy oracle's, fp32")
    check(shards == set(range(DP_RANKS)), f"both shards served: {used}")
    check(not slot_launches.get("decode_self_attention/rows/split"),
          "fp32 ragged self on simt")
    rec["slot_loop"] = {"requests": len(reqs), "tokens_equal": True,
                        "shards": sorted(shards), "s": slot_s,
                        "launches": slot_launches}
    del em, cont
    torch.cuda.empty_cache()
    # bf16: each shard launches what one device launches for its rows
    b1 = engine(flagship(0), "cuda", bf16=True, **kw)
    bm = engine(flagship(0), None, bf16=True, mesh=mesh, **kw)
    b1.translate(wavs)
    bm.translate(wavs)
    kernels.reset_launches()
    tm, sm = _timed(torch, partial(bm.translate, wavs))
    got = dict(kernels.launches)
    kernels.reset_launches()
    per = B // DP_RANKS
    for lo in range(0, B, per):
        b1.translate(wavs[lo:lo + per])
    torch.cuda.synchronize()
    want = dict(kernels.launches)
    check(got == want, f"meshed launches {got}, one device's {want}")
    for name in ("decode_self_attention_anc", "decode_cross_attention"):
        check(got.get(f"{name}/{SPLIT}", 0) == got.get(name, -1) > 0,
              f"{name} on split: {got}")
    t1, s1 = _timed(torch, partial(b1.translate, wavs))
    rec["bf16"] = {"launches": got, "launches_equal_per_shard": True,
                   "agreement": sum(a == b for a, b in zip(tm, t1)),
                   "rtfx_one": audio_s / s1, "rtfx_mesh": audio_s / sm,
                   "one_s": s1, "mesh_s": sm}
    return rec


def data_parallel_phase(torch, kernels, smi: str, root: str) -> dict:
    """Phase data_parallel (see the module docstring)."""
    backend, cards, devices = dp_layout(torch)
    t0 = time.perf_counter()
    rec = {"phase": "data_parallel", "gpu": smi, "backend": backend,
           "cards": cards, "ranks": DP_RANKS}
    rec["row0_kernels"] = _dp_row0_kernels(torch)
    rec["train"] = _dp_train(torch, kernels, root, backend)
    rec["train_s"] = time.perf_counter() - t0
    rec["serve"] = _dp_serve(torch, kernels, devices)
    rec["phase_s"] = time.perf_counter() - t0
    emit(rec)
    return rec


# phase protocol: the flagship quality run (tools/flagship_run.py) cut to
# the script's budget; the full run is 10,000 / 96 / 400 utterances, 4
# conversations of 16, and the YAML's 4,000-step schedule (warm-up and
# cool-down 400), cut here in proportion. A first run on the card made
# about 2 updates a second (24 an epoch of 2,000 utterances) and spent
# 243 s in eval_flagship with 64 held-out utterances, the hybrid 90 s of
# it; a whole run of this script with 32 of them, 200 steps and the four
# grid points read 964 s, the phase 413 s (the long-form grid 115 s of
# it). 32 held-out, 120 steps and two grid points keep the script well
# inside its 1200 s
PROTOCOL_CORPUS = dict(train_utts=2000, dev_utts=32, heldout_utts=32,
                       convs=2, utts_per_conv=8)
PROTOCOL_STEPS = 120
PROTOCOL_WARMUP = PROTOCOL_STEPS * 400 // 4000
PROTOCOL_TRAIN_BUDGET_S = 150.0  # a wall cap on fit (SIGTERM), not a target
PROTOCOL_GRID = "pause,shas_6_12"


def _finite_numbers(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite_numbers(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_finite_numbers(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return bool(np.isfinite(obj))
    return True


def protocol_phase(torch, kernels, smi: str, root: str) -> dict:
    """Phase protocol (see the module docstring): corpus, the shipped
    transformer_synth_flagship.yaml through the recipe, eval_flagship and
    the trained model's serving cell, on the card."""
    from stac_st_tpu_torch.tools import flagship_run as FR

    lines = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    report = FR.run(os.path.join(root, "flagship"), **PROTOCOL_CORPUS,
                    steps=PROTOCOL_STEPS, warmup=PROTOCOL_WARMUP,
                    budget_s=PROTOCOL_TRAIN_BUDGET_S, device="cuda",
                    grid=PROTOCOL_GRID,
                    train_log=os.path.join(OUT_DIR,
                                           "protocol_train_log.txt"),
                    emit=lines.append)
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    st = report["stages"]
    with open(os.path.join(OUT_DIR, "protocol_stages.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    corpus, train, prot, serve = (st[k] for k in ("corpus", "train",
                                                  "protocol", "serve"))
    check(train["updates"] >= PROTOCOL_STEPS or train["stopped_by_budget"],
          f"training stopped early: {train}")
    check(np.isfinite(train["final_train_loss"]), f"train loss {train}")
    tl = train["launches"]
    for name in FLASH:
        check(tl.get(name, 0) > 0, f"training launched no {name}: {tl}")
    pl = {k: v for k, v in prot["launches"].items()}
    check(pl.get("decode_self_attention/rows", 0) > 0
          and pl.get("decode_self_attention_anc", 0) > 0
          and pl.get("decode_cross_attention", 0) > 0,
          f"the protocol's decode launches {pl}")
    heldout = {r["engine"]: r for r in prot["heldout"]}
    check(sorted(heldout) == ["batch_beam10", "continuous_greedy",
                              "hybrid_finalized"], f"engines {heldout}")
    check(len(prot["speaker_change_f1"]) == 6
          and len(prot["long_form_grid"])
          == len(PROTOCOL_GRID.split(",")), "protocol tables")
    check(_finite_numbers(prot) and _finite_numbers(serve),
          "protocol numbers finite")
    beam = heldout["batch_beam10"]
    rec = {"phase": "protocol", "gpu": smi, "phase_s": phase_s,
           "corpus": {**PROTOCOL_CORPUS, "vocab": corpus["vocab"],
                      "vocab_asked": 5000},
           "stage_s": {k: v["stage_s"] for k, v in st.items()},
           "protocol_s": prot["seconds"],
           "schedule": {"steps": PROTOCOL_STEPS, "warmup": PROTOCOL_WARMUP,
                        "of": {"steps": FR.STEPS, "warmup": FR.WARMUP}},
           "grid": PROTOCOL_GRID,
           "train": {k: train[k] for k in ("updates", "micro_steps",
                                           "epochs", "final_train_loss",
                                           "last_valid",
                                           "stopped_by_budget")},
           "heldout": prot["heldout"],
           "decode_steps_per_search": beam["decode_steps_per_search"],
           "max_decode_tokens": beam["max_decode_tokens"],
           "long_form_grid": prot["long_form_grid"],
           "speaker_change_f1": prot["speaker_change_f1"],
           "serve_b16_10s": {k: serve[k] for k in (
               "translate_warm_rtfx", "translate_warm_s",
               "decode_steps_per_search", "max_decode_tokens")},
           "launches": launches,
           "launches_by_stage": {k: v["launches"] for k, v in st.items()}}
    emit(rec)
    return rec


# the reference_io phase: the reference's own data and checkpoints. A
# seeded raw Fisher/CALLHOME tree (REF_CONVS conversations of each corpus,
# REF_CONV_S each, two-channel 8 kHz mu-law SPHERE) through the port's
# multi-turn preparation at REF_TURN_S, the flagship trained REF_UPDATES
# updates over its manifests, exported to the SpeechBrain layout, imported
# back and served
REF_CONVS, REF_CONV_S, REF_TURN_S, REF_UPDATES, REF_SEED = 8, 180.0, 30, 20, 18
REF_CHECK_S, REF_CHECK_TOKENS = 4.0, 48  # the fp32 texts check, B2


class Capped:
    """A BatchLoader that stops handing out batches after ``n`` of them,
    across epochs."""

    def __init__(self, loader, n: int):
        self.loader, self.left = loader, n

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self.loader:
            if self.left <= 0:
                return
            self.left -= 1
            yield batch


def _encode_plain(enc, text):
    """``BpeEncoder.encode_as_ids`` with the merge loop in pure Python."""
    from stac_st_tpu_torch.tokenizer.bpe import normalize_text

    ids = []
    for segment, is_uds in enc._split_user_defined(normalize_text(text)):
        ids += ([enc.piece_to_id_map[segment]] if is_uds
                else enc._bpe_segment_plain(segment))
    return ids


def _per_item_ms(fn, items) -> float:
    t0 = time.perf_counter()
    for x in items:
        fn(x)
    return (time.perf_counter() - t0) / len(items) * 1e3


def _native_rates(base, tree, wav_files, texts, enc) -> dict:
    """The library's build into an empty folder, and host ms per item of
    its decoders and BPE encoder against the numpy / pure-Python versions
    on this phase's data, bitwise equal."""
    from stac_st_tpu_torch import native
    from stac_st_tpu_torch.data import audio as PA

    first_use = native.build_seconds
    t0 = time.perf_counter()
    native.build(os.path.join(base, "native_build"))
    build_s = time.perf_counter() - t0
    pcm = []
    for path in wav_files:
        with open(path, "rb") as f:
            pcm.append(f.read()[44:])  # write_wav's 44-byte header
    ulaw = []
    for name in sorted(os.listdir(tree["speech"])):
        with open(os.path.join(tree["speech"], name), "rb") as f:
            ulaw.append(f.read()[1024:])
    for data in pcm:
        check(np.array_equal(PA._pcm16_bytes(data).view(np.uint32),
                             PA._pcm16_bytes_plain(data).view(np.uint32)),
              "native PCM16 decode differs from numpy")
    for data in ulaw:
        check(np.array_equal(PA._ulaw_bytes(data).view(np.uint32),
                             PA._ulaw_bytes_plain(data).view(np.uint32)),
              "native mu-law decode differs from numpy")
    for text in texts:
        check(enc.encode_as_ids(text) == _encode_plain(enc, text),
              f"native BPE ids differ: {text!r}")
    return {
        "native_build_s": build_s, "native_first_use_build_s": first_use,
        "pcm16_utterances": len(pcm),
        "pcm16_ms_per_utt": {
            "native": _per_item_ms(PA._pcm16_bytes, pcm),
            "plain": _per_item_ms(PA._pcm16_bytes_plain, pcm)},
        "ulaw_conversations": len(ulaw),
        "ulaw_ms_per_conversation": {
            "native": _per_item_ms(PA._ulaw_bytes, ulaw),
            "plain": _per_item_ms(PA._ulaw_bytes_plain, ulaw)},
        "bpe_texts": len(texts),
        "bpe_ms_per_utt": {
            "native": _per_item_ms(enc.encode_as_ids, texts),
            "plain": _per_item_ms(lambda t: _encode_plain(enc, t), texts)},
        "bitwise_equal": True}


def _ref_prep(base) -> tuple:
    """The raw tree, the port's multi-turn preparation of both corpora and
    the training mixture; (tree, data folder, mixture manifest, record)."""
    from stac_st_tpu_torch.datasets.fisher_callhome import (
        run_data_preparation_turns as RT,
    )
    from stac_st_tpu_torch.examples.ldc_tree import make_ldc_tree
    from stac_st_tpu_torch.prep.callhome import prepare_callhome_turns
    from stac_st_tpu_torch.prep.fisher import prepare_fisher_turns

    t0 = time.perf_counter()
    tree = make_ldc_tree(os.path.join(base, "ldc"), n_fisher=REF_CONVS,
                         n_callhome=REF_CONVS, seconds=REF_CONV_S,
                         seed=REF_SEED, fisher_splits=("train",),
                         callhome_splits=("train",))
    tree["speech"] = os.path.join(tree["raw"], "LDC2010T04", "fisher_spa",
                                  "data", "speech")
    tree_s = time.perf_counter() - t0
    out = os.path.join(base, "data")
    t0 = time.perf_counter()
    prepare_fisher_turns(tree["raw"], out, REF_TURN_S,
                         corpus_path=tree["corpus"], datasets=["train"])
    t1 = time.perf_counter()
    prepare_callhome_turns(tree["raw"], out, REF_TURN_S,
                           corpus_path=tree["corpus"], datasets=["train"])
    t2 = time.perf_counter()
    parts = [os.path.join(out, f"{split}-{REF_TURN_S}s", f"data-turns-{t}.json")
             for split in ("train", "callhome-train") for t in ("asr", "st")]
    mix = "fisher-callhome-train-30s"
    RT.merge(out, mix, parts)
    manifest = os.path.join(out, mix, "data-turns-asr-st.json")
    rec = {"tree": {"conversations": 2 * REF_CONVS,
                    "conversation_s": REF_CONV_S,
                    "mapped_utterances": tree["utterances"],
                    "write_s": tree_s},
           "prepare_fisher_turns_s": t1 - t0,
           "prepare_callhome_turns_s": t2 - t1, "turn_s": REF_TURN_S}
    for name, split in (("fisher", "train"), ("callhome", "callhome-train")):
        with open(os.path.join(out, f"{split}-{REF_TURN_S}s",
                               "data-turns-st.json")) as f:
            data = json.load(f)
        text = " ".join(e["transcription"] for e in data.values())
        rec[name] = {"utterances": len(data),
                     "turn": text.count("[turn]"), "xt": text.count("[xt]"),
                     "audio_s": float(sum(e["duration"]
                                          for e in data.values()))}
        check(len(data) > 0 and rec[name]["turn"] > 0 and rec[name]["xt"] > 0,
              f"{name} turns: {rec[name]}")
    return tree, out, manifest, rec


def reference_io_phase(torch, kernels, smi: str, root: str) -> dict:
    """Phase reference_io (see the module docstring): the raw Fisher/
    CALLHOME tree through the port's preparation, the native library on its
    data, the flagship trained over the manifests, and the SpeechBrain
    export, import and serving of the trained model."""
    import copy

    from stac_st_tpu_torch.interop import sb_export
    from stac_st_tpu_torch.interop.from_jax import to_jax_params
    from stac_st_tpu_torch.ops.cmvn import CmvnState
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe
    from stac_st_tpu_torch.tools import import_sb_ckpt
    from stac_st_tpu_torch.tools.eval_flagship import _StepCounter

    base = os.path.join(root, "reference_io")
    t_phase = time.perf_counter()
    tree, out, manifest, prep = _ref_prep(base)
    rec = {"phase": "reference_io", "gpu": smi, "prep": prep}
    with open(manifest) as f:
        entries = json.load(f)
    lines = [e["transcription_and_translation"] for e in entries.values()]
    t0 = time.perf_counter()
    tok_path = os.path.join(base, "bpe.model")
    train_bpe(lines, vocab_size=600, user_defined_symbols=[
        "[es]", "[en]", "[turn]", "[xt]"]).save(tok_path)
    tok = SentencePieceProcessor(tok_path)
    rec["tokenizer"] = {"vocab": tok.get_piece_size(),
                        "train_s": time.perf_counter() - t0}
    texts = [t for e in entries.values()
             for t in (e["transcription"], e["translation_0"])]
    wav_files = sorted({e["wav"] for e in entries.values()})
    rec["native"] = _native_rates(base, tree, wav_files, texts, tok._enc())
    loader_rate(corpus_loader(manifest, out, tok, None, 4))  # page cache
    rec["native"]["loader_audio_s_per_s"] = {
        f"workers{w}": loader_rate(corpus_loader(manifest, out, tok, None, w))
        for w in (1, 4)}

    # (c) the flagship over the prepared manifests
    loader = corpus_loader(manifest, out, tok, None, 4)
    trainer = _trainer(torch, flagship(REF_SEED), bf16=True)
    feeds, losses, epoch = Capped(loader, REF_UPDATES), [], 0
    kernels.reset_launches()
    t0 = time.perf_counter()
    while feeds.left > 0:
        epoch += 1
        trainer.fit([epoch], feeds)
        losses += [float(x) for x in trainer.epoch_losses]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(kernels.launches)
    check(trainer.state.optimizer_step == REF_UPDATES
          and len(losses) == REF_UPDATES and all(np.isfinite(losses)),
          f"fit: {trainer.state.optimizer_step} updates, losses {losses}")
    for name in FLASH[1:]:
        check(fit_launches.get(name, 0) == 18 * REF_UPDATES
              and fit_launches.get(f"{name}/{TC}", 0) == 18 * REF_UPDATES,
              f"{name}: {fit_launches}, want 18 a step on {TC}")
    rec["train"] = {"updates": REF_UPDATES, "epochs": epoch, "fit_s": fit_s,
                    "batches_per_epoch": len(loader), "losses": losses,
                    "launches": fit_launches}

    # (d) SpeechBrain export, import, save_imported, serving
    cfg = trainer.cfg
    trained_mods = (cfg.cnn, cfg.transformer, cfg.seq_lin, cfg.ctc_lin)
    trained = to_jax_params(*trained_mods)
    sb_dir, exp = os.path.join(base, "sb"), os.path.join(base, "exp")
    os.makedirs(sb_dir, exist_ok=True)
    t0 = time.perf_counter()
    sd = sb_export.export_modules(*trained_mods)
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
               os.path.join(sb_dir, "model.ckpt"))
    stats = sb_export.export_normalizer_dict(trainer.state.cmvn)
    torch.save({k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
                else v for k, v in stats.items()},
               os.path.join(sb_dir, "normalizer.ckpt"))
    check(import_sb_ckpt.main([sb_dir, os.path.join(exp, "save")]) == 0,
          "import_sb_ckpt")
    sb_s = time.perf_counter() - t0

    def served_engine(**kw):
        return STEngine.from_experiment(exp, tok_path, device="cuda", **kw)

    eng32 = served_engine(bf16=False, beam_size=BEAM,
                          max_decode_tokens=REF_CHECK_TOKENS)
    check(trees_equal(to_jax_params(eng32._cnn, eng32._transformer,
                                    eng32.searcher.seq_lin, eng32._ctc_lin),
                      trained), "imported parameters differ from the trained")
    cmvn = CmvnState(*(t.detach().cpu() for t in trainer.state.cmvn))
    check(all(torch.equal(a.cpu(), b) for a, b in zip(eng32.cmvn, cmvn)),
          "imported normalizer differs from the trained")
    ref32 = STEngine(*(copy.deepcopy(m) for m in (cfg.transformer, cfg.cnn,
                                                  cfg.seq_lin, cfg.ctc_lin)),
                     cmvn, tok, device="cuda", bf16=False, beam_size=BEAM,
                     max_decode_tokens=REF_CHECK_TOKENS)
    rng = np.random.default_rng(REF_SEED)
    check_wavs = [(rng.standard_normal(int(REF_CHECK_S * SR)) * 3000)
                  .astype(np.int16) for _ in range(2)]
    texts_imported = eng32.translate(check_wavs)
    texts_trained = ref32.translate(check_wavs)
    check(texts_imported == texts_trained,
          f"fp32 texts: imported {texts_imported} trained {texts_trained}")
    del eng32, ref32

    wavs = serving_wavs()
    served = {}
    for label, beam, batch in (("beam10", BEAM, wavs), ("beam1", 1, wavs[:2])):
        eng = served_engine(bf16=True, beam_size=beam, max_decode_tokens=192,
                            transfer_dtype="int16")
        eng.translate(batch)  # first call: set-up
        torch.cuda.synchronize()
        counter = _StepCounter(eng)
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = eng.translate(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launches.items()
                    if k.startswith("decode_")}
        counter.restore()
        check(len(got) == len(batch) and all(isinstance(t, str) for t in got),
              f"{label} texts")
        names = (("decode_self_attention_anc", "decode_cross_attention")
                 if beam > 1 else ("decode_self_attention",
                                   "decode_cross_attention"))
        want = {f"{n}{v}": 6 * counter.steps for n in names
                for v in ("", f"/{SPLIT}")}
        check(launches == want, f"{label}: launches {launches}, want {want}")
        served[label] = {"batch": len(batch), "seconds": SECONDS,
                         "warm_s": wall,
                         "rtfx": len(batch) * SECONDS / wall,
                         "decode_steps": counter.steps,
                         "searches": counter.searches,
                         "launches": launches}
        del eng
    rec["sb"] = {"parameters": int(sum(v.size for v in sd.values())),
                 "export_import_s": sb_s, "parameters_bitwise": True,
                 "fp32_texts_equal": True, "fp32_check": {
                     "batch": 2, "seconds": REF_CHECK_S, "beam": BEAM,
                     "max_decode_tokens": REF_CHECK_TOKENS},
                 "served": served}
    total = dict(fit_launches)
    for call in served.values():
        for name, n in call["launches"].items():
            total[name] = total.get(name, 0) + n
    rec["launches"] = total
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


def card_vs_cpu_phase(torch, kernels):
    """The port on the card against the port on the CPU, fp32, 2 x 2 s:
    a decode step's logits, the attention-only search's tokens and
    lengths, and those of the joint CTC/attention search (ctc_weight 0.3,
    the model's CTC head; the CTC kernel on the card, its plain version on
    the CPU)."""
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
            tokens, lengths, _, _ = eng.searcher.search(enc, prompt)
            ctc = torch.log_softmax(eng._ctc_lin(enc).float(), dim=-1)
            eng.searcher.config = eng.searcher.config._replace(
                ctc_weight=CTC_WEIGHT)
            kernels.reset_launches()
            joint, joint_len, _, _ = eng.searcher.search(
                enc, prompt, wav_lens=lens, ctc_log_probs=ctc)
            ctc_launches = kernels.launches.get("ctc_prefix_score", 0)
        check((ctc_launches > 0) == (dev == "cuda"),
              f"card vs CPU joint search on {dev}: {ctc_launches} CTC "
              "launches")
        outs[dev] = (logits.float().cpu(), tokens.cpu(), lengths.cpu(),
                     joint.cpu(), joint_len.cpu())
    err = (outs["cuda"][0] - outs["cpu"][0]).abs().max().item()
    check(err <= 1e-3, f"card vs CPU decode-step logits: err {err}")

    def agreement(i):
        """(token agreement, lengths equal) of the search at outs[dev][i]."""
        tok_c, len_c = outs["cuda"][i], outs["cuda"][i + 1]
        tok_h, len_h = outs["cpu"][i], outs["cpu"][i + 1]
        steps = min(tok_c.shape[1], tok_h.shape[1])
        same = (tok_c[:, :steps] == tok_h[:, :steps]).float().mean().item()
        return same, bool(torch.equal(len_c, len_h))

    (same, equal), (joint_same, joint_equal) = agreement(1), agreement(3)
    rec.update({"logits_max_abs_err": err, "logits_atol": 1e-3,
                "translate_token_agreement": same, "lengths_equal": equal,
                "joint_ctc_weight": CTC_WEIGHT,
                "joint_ctc_token_agreement": joint_same,
                "joint_ctc_lengths_equal": joint_equal})
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
    built = kernels.build(["decode_attention", "train_attention",
                           "ctc_prefix"])
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
    main_rec, main_texts, beam1_texts = main_path_phase(torch, kernels,
                                                        args.profile)
    int8_rec = int8_phase(torch, kernels, main_texts, beam1_texts, main_rec,
                          args.profile)
    speculative_phase(torch, kernels)
    options = search_options_phase(torch, kernels, K, timer, args.profile)
    _, train_launches = train_phase(torch, kernels, args.profile)
    data_train_phase(torch, kernels, args.profile)
    with tempfile.TemporaryDirectory() as root:
        recipe = recipe_phase(torch, kernels, smi, root)
        served = serve_phase(torch, kernels, K, smi, root, args.profile)
        encoders_phase(torch, kernels, smi, root)
        data_parallel_phase(torch, kernels, smi, root)
        protocol = protocol_phase(torch, kernels, smi, root)
        ref_io = reference_io_phase(torch, kernels, smi, root)
    card_vs_cpu_phase(torch, kernels)
    card_vs_cpu_train_phase(torch)

    kernel_line = []
    for rec in rows:
        bf = rec["bfloat16"]
        # the ragged self forms: their launches are the serve phase's; the
        # int8 kernels' the int8 phase's (the int8 cache's translate)
        ragged = rec["name"].endswith("/rows")
        replaces, source = K.KERNELS[rec["name"].split("/")[0]]
        path = (served["launches"] if ragged
                else int8_rec["kv_int8"]["launches"] if "int8" in rec["name"]
                else main_rec["launches"])
        kernel_line.append({
            "name": rec["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": path.get(rec["name"], 0),
            "recipe_launches": recipe["launches"].get(rec["name"], 0),
            "serve_launches": served["launches"].get(rec["name"], 0),
            "protocol_launches": protocol["launches"].get(rec["name"], 0),
            "reference_io_launches": ref_io["launches"].get(rec["name"], 0),
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
        })
        if rec["name"] in DECODE_SPLIT or ragged or "int8" in rec["name"]:
            kernel_line[-1]["variant"] = "/".join(
                v for v in (SPLIT, "simt") if path.get(f"{rec['name']}/{v}"))
    flash_kernels = {**A.KERNELS, **TA.KERNELS}
    for rec in train_rows:
        enc = rec["encoder_self"]  # the shape of 12 of the 18 launches
        replaces, source = flash_kernels[rec["name"]]
        kernel_line.append({
            "name": rec["name"], "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": train_launches.get(rec["name"], 0),
            "recipe_launches": recipe["launches"].get(rec["name"], 0),
            "protocol_launches": protocol["launches"].get(rec["name"], 0),
            "reference_io_launches": ref_io["launches"].get(rec["name"], 0),
            "max_abs_err": max(v for k, v in rec["abs_err"].items()
                               if "bfloat16" in k),
            "ms": enc["ms"], "plain_ms": enc["plain_ms"],
            "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
            "library_ms": enc["library_ms"],
            "variant": "/".join(v for v in VARIANTS
                                if train_launches.get(f"{rec['name']}/{v}")),
        })
    from stac_st_tpu_torch.ops.kernels import ctc_prefix as KC

    ctc = options["kernel"]["joint"]
    replaces, source = KC.KERNELS["ctc_prefix_score"]
    kernel_line.append({
        "name": "ctc_prefix_score", "route": "cuda", "source": source,
        "replaces": replaces, "kernel": options["kernel"]["kernel"],
        # one launch a decode step of the joint search (float cache)
        "launches": options["joint_ctc"]["float"]["ctc_prefix_score_launches"],
        "protocol_launches": protocol["launches"].get("ctc_prefix_score", 0),
        "max_abs_err": ctc["max_abs_err"], "ms": ctc["ms"],
        "plain_ms": ctc["plain_ms"], "bound_ms": ctc["bound_ms"],
        "bound_by": ctc["bound_by"], "library_ms": None,
    })
    print(smi, flush=True)
    emit({"kernels": kernel_line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
