#!/usr/bin/env python3
"""Flagship-shape quality protocol on the trained synthetic-corpus model
(port of ``tools/eval_flagship.py``: the same protocols and report keys,
plus each row's decode steps).

Stage 3 of the flagship quality run: takes the experiment directory
produced by ``stac_st_tpu_torch.recipes.train_multitask`` with
``recipes/hparams/transformer_synth_flagship.yaml`` (d256/4h/12+6L,
vocab 5000 — the reference's published small preset, its
``ablations/run_m_and_l_size.sh:72-99``) and runs every quality protocol
at that shape in a NON-memorized regime (held-out sentences from the same
lexicon):

1. held-out beam-10 test protocol (eos-threshold + length-norm +
   temperature 1.15) vs continuous greedy vs the hybrid
   (``protocol_finalize``) — corpus BLEU (ST) + WER (ASR), markers
   stripped from hyps AND refs, plus wall-clock RTFx per engine;
2. the long-form L7 protocol: segmentation grid (pause VAD + SHAS pDAC)
   → ``engine.long_form`` → min-WER realignment → BLEU/WER ±markers;
3. speaker-change F1 over the reference tolerance grid
   (ground-truth-segmentation leg).

The beam-10 row also reports the timed pass's decoder steps per search
(``decode_steps_per_search``) against the budget (``max_decode_tokens``):
a search stops early only when every hypothesis has met eos. The report's
``seconds`` gives each part's wall time (engine load, both beam-10
passes, greedy, the hybrid, the long-form grid, speaker change). Runs on the
card; ``--cpu`` (the JAX script's flag) or ``--device cpu`` on the CPU.

Usage::

    python -m stac_st_tpu_torch.tools.eval_flagship \
        --exp results/flagship_synth/8886 --data DATA_DIR \
        [--out results/flagship_synth/eval.json]
"""

import argparse
import glob
import json
import os
import time
import wave

import numpy as np

SR = 16000
MAX_DECODE_TOKENS = 192


def load_wav(path):
    with wave.open(path, "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return pcm.astype(np.float32) / 32768.0


def strip_markers(t):
    return " ".join(w for w in t.split() if w not in ("[turn]", "[xt]"))


def load_split(data_dir, split):
    with open(os.path.join(data_dir, split, "data-st.json")) as f:
        meta = json.load(f)
    uids = sorted(meta)
    wavs = [load_wav(meta[u]["wav"].replace("{data_root}", data_dir))
            for u in uids]
    refs_es = [meta[u]["transcription"] for u in uids]
    refs_en = [meta[u]["translation_0"] for u in uids]
    return uids, wavs, refs_es, refs_en


def score(asr_hyp, st_hyp, refs_es, refs_en):
    from ..utils.metrics import BLEUStats, ErrorRateStats

    ids = [f"u{i}" for i in range(len(st_hyp))]
    bleu = BLEUStats()
    bleu.append(ids, [strip_markers(t) for t in st_hyp],
                [[strip_markers(r) for r in refs_en]])
    wer = ErrorRateStats()
    wer.append(ids, [strip_markers(t).split() for t in asr_hyp],
               [strip_markers(r).split() for r in refs_es])
    return (round(float(bleu.summarize("BLEU")), 2),
            round(float(wer.summarize("WER")), 2))


class _StepCounter:
    """Counts the engine's searches and its decoder steps (each step of a
    search is one ``decode_step`` call over all its rows) until
    ``restore``."""

    def __init__(self, engine):
        self.model, self.searcher = engine._transformer, engine.searcher
        self.steps = self.searches = 0
        step, multi = self.model.decode_step, self.searcher.call_multi

        def decode_step(*a, **kw):
            self.steps += 1
            return step(*a, **kw)

        def call_multi(*a, **kw):
            self.searches += 1
            return multi(*a, **kw)

        self.model.decode_step = decode_step
        self.searcher.call_multi = call_multi

    def restore(self):
        del self.model.decode_step
        del self.searcher.call_multi


def load_conversations(data_dir):
    conv_dir = os.path.join(data_dir, "conversations")
    with open(os.path.join(conv_dir, "data-longform.json")) as f:
        manifest = json.load(f)
    by_conv = {}
    for uid, entry in manifest.items():
        c = uid.split("-")[0]
        by_conv.setdefault(c, []).append((entry["offset"], uid))
    convs = []
    for c in sorted(by_conv):
        idx = int(c.replace("lconv", ""))
        wav = load_wav(os.path.join(conv_dir, "wav", f"lconv{idx:02d}.wav"))
        ref_uids = [u for _, u in sorted(by_conv[c])]
        convs.append({"uri": c, "wav": wav, "ref_uids": ref_uids})
    man_path = os.path.join(conv_dir, "data-longform.json")
    return convs, manifest, man_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--split", default="heldout")
    ap.add_argument("--grid", default="pause,shas_4_8,shas_6_12,shas_8_16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU (the JAX script's flag; --device cpu)")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap held-out utterances (0 = all)")
    ap.add_argument("--skip-longform", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ..evaluations.vad_shas.run_full_protocol import score_grid_point
    from ..serving import STEngine
    from ..serving_continuous import ContinuousBatchingEngine
    from ..tokenizer import SentencePieceProcessor

    toks = sorted(glob.glob(os.path.join(args.data, "tok", "*.model")))
    if not toks:
        raise SystemExit(f"no tokenizer model under {args.data}/tok")
    tok_file = toks[0]
    sp = SentencePieceProcessor(tok_file)
    seconds, clock = {}, [time.perf_counter()]

    def lap(name):
        """Wall seconds since the previous lap, under ``name``."""
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    # pad_batch_rows=16: every search of the batch engine, the hybrid
    # finalizer and the chunked calls below is a 16-row batch of a bucket
    engine = STEngine.from_saved_experiment(
        args.exp, tokenizer_file=tok_file,
        beam_size=10, bucket_seconds=(2.5, 4.0, 6.0, 8.0, 14.0),
        max_decode_tokens=MAX_DECODE_TOKENS, pad_batch_rows=16,
        turn_id=sp.piece_to_id("[turn]"), xt_id=sp.piece_to_id("[xt]"),
        device=device,
    )
    lap("engine_load")

    uids, wavs, refs_es, refs_en = load_split(args.data, args.split)
    if args.limit:
        uids, wavs = uids[:args.limit], wavs[:args.limit]
        refs_es, refs_en = refs_es[:args.limit], refs_en[:args.limit]
    audio_s = sum(len(w) for w in wavs) / SR
    report = {"metric": "flagship_quality_protocol", "exp": args.exp,
              "split": args.split, "n_utts": len(wavs),
              "audio_seconds": round(audio_s, 1), "seconds": seconds}
    rows = []

    def chunked(call, wavs, chunk=16):
        """Duration-sorted fixed-size chunks: every device call hits a
        pre-padded (16-row, bucket) shape; results restored to input
        order."""
        order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
        out = [None] * len(wavs)
        for k in range(0, len(order), chunk):
            idx = order[k:k + chunk]
            for i, text in zip(idx, call([wavs[i] for i in idx])):
                out[i] = text
        return out

    # ---- batch beam-10 (the reference test protocol) --------------------
    # pass 1 warms every (16-row, bucket) shape; pass 2 is the timed one
    asr_b = chunked(engine.transcribe, wavs)
    st_b = chunked(engine.translate, wavs)
    counts = _StepCounter(engine)
    t0 = time.perf_counter()
    asr_b = chunked(engine.transcribe, wavs)
    st_b = chunked(engine.translate, wavs)
    dt = time.perf_counter() - t0
    counts.restore()
    bleu, wer = score(asr_b, st_b, refs_es, refs_en)
    rows.append({"engine": "batch_beam10", "st_bleu": bleu, "asr_wer": wer,
                 "rtfx": round(2 * audio_s / dt, 1),
                 "searches": counts.searches,
                 "decode_steps_per_search": (counts.steps
                                             / max(counts.searches, 1)),
                 "max_decode_tokens": MAX_DECODE_TOKENS})
    print(json.dumps(rows[-1]), flush=True)

    lap("batch_beam10")

    # ---- continuous greedy ----------------------------------------------
    cont = ContinuousBatchingEngine(engine, slots=16, chunk=16)
    try:
        cont.warmup()
        t0 = time.perf_counter()
        asr_g = cont.transcribe(wavs)
        st_g = cont.translate(wavs)
        dt = time.perf_counter() - t0
    finally:
        cont.close()
    bleu_g, wer_g = score(asr_g, st_g, refs_es, refs_en)
    rows.append({"engine": "continuous_greedy", "st_bleu": bleu_g,
                 "asr_wer": wer_g, "rtfx": round(2 * audio_s / dt, 1)})
    print(json.dumps(rows[-1]), flush=True)

    lap("continuous_greedy")

    # ---- hybrid: greedy draft + protocol-exact finalization -------------
    hyb = ContinuousBatchingEngine(engine, slots=16, chunk=16,
                                   protocol_finalize=True)
    try:
        hyb.warmup()
        t0 = time.perf_counter()
        asr_h = hyb.transcribe(wavs)
        st_h = hyb.translate(wavs)
        dt = time.perf_counter() - t0
        hstats = hyb.stats()
    finally:
        hyb.close()
    exact_batch = (asr_h == asr_b and st_h == st_b)
    bleu_h, wer_h = score(asr_h, st_h, refs_es, refs_en)
    rows.append({
        "engine": "hybrid_finalized", "st_bleu": bleu_h, "asr_wer": wer_h,
        "rtfx": round(2 * audio_s / dt, 1),
        "final_matches_batch_engine": bool(exact_batch),
        "draft_exact_rate": round(
            hstats.get("draft_exact", 0)
            / max(hstats.get("finalized", 1), 1), 3),
    })
    print(json.dumps(rows[-1]), flush=True)
    report["heldout"] = rows
    lap("hybrid_finalized")

    # ---- long-form L7 protocol ------------------------------------------
    if not args.skip_longform:
        convs, manifest, man_path = load_conversations(args.data)
        grid_rows = []
        for point in args.grid.split(","):
            point = point.strip()
            if point == "pause":
                kw = {"segmentation": "pause"}
            else:
                _, lo, hi = point.split("_")
                kw = {"segmentation": "shas",
                      "dac_min_segment_length": float(lo),
                      "dac_max_segment_length": float(hi)}
            results = []
            t0 = time.perf_counter()
            for conv in convs:
                r = engine.long_form(conv["wav"], uri=conv["uri"], **kw)
                r["raw"] = {
                    "transcription": " ".join(
                        s["transcription"] for s in r["segments"]),
                    "translation": " ".join(
                        s["translation"] for s in r["segments"]),
                }
                results.append(r)
            dt = time.perf_counter() - t0
            conv_s = sum(len(c["wav"]) for c in convs) / SR
            bleu_l, wer_l = score_grid_point(convs, manifest, results,
                                             with_markers=False)
            bleu_t, wer_t = score_grid_point(convs, manifest, results,
                                             with_markers=True)
            row = {"grid": point,
                   "segments": sum(len(r["segments"]) for r in results),
                   "st_bleu": bleu_l, "asr_wer": wer_l,
                   "st_bleu_with_turns": bleu_t,
                   "asr_wer_with_turns": wer_t,
                   "rtfx": round(conv_s / dt, 1)}
            grid_rows.append(row)
            print(json.dumps(row), flush=True)
        report["long_form_grid"] = grid_rows
        lap("long_form_grid")

        # ---- speaker-change F1 (ground-truth segmentation leg) ----------
        from ..eval.speaker_change import (
            TOLERANCE_GRID,
            evaluate_speaker_change,
            gt_changes_from_manifest,
        )

        gt = gt_changes_from_manifest(man_path)
        swavs, suids = [], []
        for uid, entry in sorted(manifest.items()):
            swavs.append(load_wav(entry["wav"]))
            suids.append(uid)
        turns = engine.speaker_turns(swavs)
        hyp = {uid: t["turn"] for uid, t in zip(suids, turns)}
        f1_rows = []
        for m in evaluate_speaker_change(gt, hyp, TOLERANCE_GRID):
            d = {k: round(float(v), 3) for k, v in m.as_dict().items()}
            f1_rows.append(d)
            print(json.dumps(d), flush=True)
        report["speaker_change_f1"] = f1_rows
        lap("speaker_change")

    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
