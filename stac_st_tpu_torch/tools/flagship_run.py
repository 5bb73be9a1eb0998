"""The flagship quality run end to end with the port, one stage after
another in one process:

1. ``corpus``: ``flagship_corpus`` (the learnable synthetic corpus, its
   conversations and the BPE tokenizer);
2. ``train``: ``recipes.train_multitask`` on the shipped
   ``recipes/hparams/transformer_synth_flagship.yaml`` (d256, 4 heads,
   12 + 6 layers, vocab 5000, bf16), overriding only the paths and, when
   asked, the schedule's step limit, warm-up and cool-down; an optional
   wall budget stops ``fit`` with a SIGTERM (a preempted checkpoint; the
   kept ACC checkpoints are what the next stages load);
3. ``protocol``: ``eval_flagship`` on the experiment (held-out beam 10,
   continuous greedy and the hybrid; the long-form grid; speaker-change
   F1);
4. ``serve``: the trained experiment's warm ``translate`` of B16 x 10 s
   (held-out utterances, each padded with silence or cut to 10 s; beam 10,
   192 tokens, bf16, the serving configuration), with its decoder steps
   per search.

Each stage prints one JSON line with its wall seconds (``stage_s``) and
the kernel launches it made (by kernel and variant); the last line is the
whole report.
Runs on the card (``--device cpu`` on the CPU).

    python -m stac_st_tpu_torch.tools.flagship_run --workdir DIR
        [--train-utts 10000 --dev-utts 96 --heldout-utts 400 --convs 4
         --utts-per-conv 16] [--steps 4000 --warmup 400]
        [--train-budget-s S] [--heldout-limit N]
        [--key=value recipe overrides ...]
"""

import argparse
import contextlib
import json
import os
import signal
import sys
import threading
import time

import numpy as np

from ..ops import kernels

YAML = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "recipes", "hparams",
    "transformer_synth_flagship.yaml")
# the YAML's schedule: scheduler_step_limit, n_warmup_steps, cooldown
STEPS, WARMUP = 4000, 400
SERVE_B, SERVE_S, SR = 16, 10.0, 16000


def _launches_since(before):
    return {k: v - before.get(k, 0) for k, v in kernels.launches.items()
            if v != before.get(k, 0)}


def _sync(device):
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def corpus_stage(data, train_utts, dev_utts, heldout_utts, convs,
                 utts_per_conv, vocab=5000):
    from . import flagship_corpus

    return flagship_corpus.main([
        "--out", data, "--train-utts", str(train_utts),
        "--dev-utts", str(dev_utts), "--heldout-utts", str(heldout_utts),
        "--convs", str(convs), "--utts-per-conv", str(utts_per_conv),
        "--vocab", str(vocab)])


def train_stage(data, tokenizer, exp, steps=STEPS, warmup=WARMUP,
                device="cuda", budget_s=None, log=None, extra=()):
    """The recipe on the YAML; the schedule cut to ``steps`` and
    ``warmup`` (cool-down = warm-up, as the YAML sets them); ``extra``
    recipe overrides appended. Returns the stage's record."""
    from ..recipes import train_multitask

    argv = [YAML, f"--device={device}", f"--data_folder={data}",
            f"--tokenizer_file={tokenizer}", f"--output_folder={exp}"]
    if steps != STEPS or warmup != WARMUP:
        argv += [f"--scheduler_step_limit={steps}",
                 f"--n_warmup_steps={warmup}", f"--cooldown={warmup}"]
    argv += list(extra)
    timer = previous = None
    if budget_s:
        # fit traps SIGTERM while it runs; outside it (set-up, the
        # recipe's evaluation) this handler drops the budget's signal
        previous = signal.signal(signal.SIGTERM, lambda signum, frame: None)
        timer = threading.Timer(
            budget_s, lambda: os.kill(os.getpid(), signal.SIGTERM))
        timer.daemon = True
        timer.start()
    out = open(log, "w") if log else contextlib.nullcontext(sys.stdout)
    try:
        with out as f, contextlib.redirect_stdout(f):
            trainer = train_multitask.main(argv)
    finally:
        if timer is not None:
            timer.cancel()
            signal.signal(signal.SIGTERM, previous)
    _sync(device)
    st = trainer.state
    return {
        "overrides": argv[1:], "updates": int(st.optimizer_step),
        "micro_steps": int(st.micro_step),
        "epochs": int(trainer.hparams["epoch_counter"].current),
        "final_train_loss": float(trainer.train_stats.get("loss", np.nan)),
        "last_valid": {k: v for k, v in trainer.last_valid_stats.items()
                       if isinstance(v, (int, float))},
        "stopped_by_budget": bool(trainer.preempted)}


def serve_stage(exp, tokenizer, data, device="cuda"):
    """Warm ``translate`` of B16 x 10 s held-out audio on the trained
    experiment (serving configuration)."""
    from ..serving import STEngine
    from .eval_flagship import _StepCounter, load_split

    eng = STEngine.from_saved_experiment(exp, tokenizer_file=tokenizer,
                                         device=device)
    _, wavs, _, _ = load_split(data, "heldout")
    n = int(SERVE_S * SR)
    batch = [np.pad(w[:n], (0, max(0, n - len(w)))) for w in
             wavs[:SERVE_B]]
    eng.translate(batch)  # first call: set-up
    _sync(device)
    counts = _StepCounter(eng)
    t0 = time.perf_counter()
    texts = eng.translate(batch)
    _sync(device)
    wall = time.perf_counter() - t0
    counts.restore()
    return {"batch": len(batch), "seconds": SERVE_S,
            "beam": eng.searcher.config.beam_size,
            "max_decode_tokens": eng.searcher.max_decode_tokens,
            "translate_warm_s": wall,
            "translate_warm_rtfx": len(batch) * SERVE_S / wall,
            "searches": counts.searches,
            "decode_steps_per_search": counts.steps / max(counts.searches,
                                                          1),
            "translations": texts[:2]}


def run(workdir, train_utts=10000, dev_utts=96, heldout_utts=400, convs=4,
        utts_per_conv=16, steps=STEPS, warmup=WARMUP, budget_s=None,
        device="cuda", grid="pause,shas_4_8,shas_6_12,shas_8_16",
        train_log=None, extra=(), emit=print, heldout_limit=0):
    """Every stage in turn; ``emit`` gets each stage's JSON line. Returns
    the report."""
    from . import eval_flagship

    data, exp = os.path.join(workdir, "data"), os.path.join(workdir, "exp")
    report = {"stages": {}}

    def stage(name, fn):
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        rec = fn()
        _sync(device)
        rec = dict(rec, stage_s=time.perf_counter() - t0,
                   launches=_launches_since(before))
        report["stages"][name] = rec
        emit(json.dumps({"stage": name, **rec}, default=str))
        return rec

    corpus = stage("corpus", lambda: corpus_stage(
        data, train_utts, dev_utts, heldout_utts, convs, utts_per_conv))
    tok = corpus["tokenizer"]
    stage("train", lambda: train_stage(data, tok, exp, steps, warmup,
                                       device, budget_s, train_log,
                                       extra))
    stage("protocol", lambda: eval_flagship.main(
        ["--exp", exp, "--data", data, "--device", device, "--grid", grid,
         "--limit", str(heldout_limit)]))
    stage("serve", lambda: serve_stage(exp, tok, data, device))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--train-utts", type=int, default=10000)
    ap.add_argument("--dev-utts", type=int, default=96)
    ap.add_argument("--heldout-utts", type=int, default=400)
    ap.add_argument("--convs", type=int, default=4)
    ap.add_argument("--utts-per-conv", type=int, default=16)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--train-budget-s", type=float, default=None,
                    help="stop fit with a SIGTERM after this many seconds")
    ap.add_argument("--train-log", default=None,
                    help="the recipe's output goes here (default stdout)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", default="pause,shas_4_8,shas_6_12,shas_8_16")
    ap.add_argument("--heldout-limit", type=int, default=0,
                    help="the protocol's first N held-out utterances "
                         "(0: all)")
    args, extra = ap.parse_known_args(argv)
    if str(args.device).startswith("cuda"):
        kernels.build(["decode_attention", "train_attention", "ctc_prefix"])
    report = run(args.workdir, args.train_utts, args.dev_utts,
                 args.heldout_utts, args.convs, args.utts_per_conv,
                 args.steps, args.warmup, args.train_budget_s, args.device,
                 args.grid, args.train_log, extra,
                 heldout_limit=args.heldout_limit)
    print(json.dumps(report, default=str))
    return report


if __name__ == "__main__":
    main()
