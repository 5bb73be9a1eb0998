#!/usr/bin/env python3
"""Full long-form L7 protocol in ONE command, on a synthetic fixture (port
of ``evaluations/vad_shas/run_full_protocol.py``, the same table).

The reference needs four stages for its long-form evaluation
(`run_shas_segmentation.sh` over a min/max grid → `inference.py` →
`fix_RTTM.py` → mwerSegmenter realign + `run_align_and_eval.sh`
scoring). This script runs the complete protocol end to end on a
synthetic multi-turn fixture, in one command, on the card (``--device
cpu`` on the CPU; ``--tpu``, the JAX script's flag for its accelerator,
is accepted and keeps the card):

  1. train a tiny multitask model on a synthetic Fisher-style mixture
     corpus (ASR+ST prompts, [turn] markers);
  2. build long-form conversations (fixture utterances + silence gaps);
  3. segmentation GRID: pause-VAD plus SHAS pDAC at several
     (min,max) points (the reference grid is 10_15..10_30 —
     run_shas_segmentation.sh:137 — scaled to the fixture length here,
     selectable via --grid);
  4. decode each grid point with engine.long_form (fused dual ASR+ST
     search + CTC turn head in one program);
  5. realign the merged hypothesis stream to the reference utterances
     (eval/long_form.py minimum-WER segmentation, the mwerSegmenter
     equivalent pinned by tests/test_eval.py fixtures);
  6. score BLEU (ST) and WER (ASR), each with and without the
     [turn]/[xt] marker tokens (the reference's ±turn-token variants);
  7. speaker-change F1 over the tolerance grid on the ground-truth
     segmentation leg (engine.speaker_turns vs manifest turns), as
     run_eval_speaker_change does.

Prints one JSON results table.

  python -m stac_st_tpu_torch.evaluations.vad_shas.run_full_protocol
      [--epochs 60] [--grid pause,shas_3_6,shas_5_10] [--device cpu]
"""

import argparse
import json
import os
import wave

import numpy as np

SR = 16000


def build_conversations(workdir, n_convs=2, utts_per_conv=6,
                        gap_s=0.6, seed=0):
    """Long-form fixture: concatenated corpus utterances with silence
    gaps. Returns (conversations, manifest, manifest path) where manifest
    maps reference-utterance uid -> entry (turns metadata included for the
    speaker-change leg)."""
    split = os.path.join(workdir, "split_0")
    with open(os.path.join(split, "data-st.json")) as f:
        meta = json.load(f)
    uids = sorted(meta)

    convs, manifest = [], {}
    k = 0
    for c in range(n_convs):
        wav_parts = [np.zeros(int(gap_s * SR), np.float32)]
        t = gap_s
        utt_refs = []
        for _ in range(utts_per_conv):
            uid = uids[k % len(uids)]
            k += 1
            entry = meta[uid]
            path = entry["wav"].replace("{data_root}", split)
            with wave.open(path, "rb") as w:
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            wav = pcm.astype(np.float32) / 32768.0
            dur = len(wav) / SR
            start_cs, end_cs = int(round(t * 100)), int(
                round((t + dur) * 100))
            ref_uid = f"conv{c}-0-{start_cs:06d}-{end_cs:06d}"
            es, en = entry["transcription"], entry["translation_0"]
            m = {
                "wav": path, "duration": dur,
                "transcription": es, "translation_0": en,
                "offset": t,
            }
            if "[turn]" in es:
                # the [turn] marker sits mid-text; the synthetic GT
                # change time is the utterance midpoint (space-joined
                # strings = the reference turns-manifest format)
                m["segments_start"] = f"0.0 {dur / 2:.3f}"
                m["segments_channel"] = "0 1"
            else:
                m["segments_start"] = "0.0"
                m["segments_channel"] = "0"
            manifest[ref_uid] = m
            utt_refs.append(ref_uid)
            wav_parts.append(wav)
            wav_parts.append(np.zeros(int(gap_s * SR), np.float32))
            t += dur + gap_s
        convs.append({
            "uri": f"conv{c}",
            "wav": np.concatenate(wav_parts),
            "ref_uids": utt_refs,
        })
    man_path = os.path.join(workdir, "data-longform.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return convs, manifest, man_path


def strip_markers(text):
    return " ".join(
        w for w in text.split() if w not in ("[turn]", "[xt]"))


def score_grid_point(convs, manifest, results, with_markers):
    """Realign each conversation's merged stream to its reference
    utterances and score corpus BLEU + WER."""
    from ...eval.long_form import realign_hypotheses
    from ...utils.metrics import BLEUStats, ErrorRateStats

    bleu, wer = BLEUStats(), ErrorRateStats()
    for conv, res in zip(convs, results):
        for metric, field, hyp_key in (
            (bleu, "translation_0", "translation"),
            (wer, "transcription", "transcription"),
        ):
            refs = [manifest[u][field] for u in conv["ref_uids"]]
            if not with_markers:
                refs = [strip_markers(r) for r in refs]
            refs = [" ".join(r.split()) for r in refs]
            stream = res["raw"][hyp_key] if with_markers else res[hyp_key]
            realigned = realign_hypotheses(refs, " ".join(stream.split()))
            ids = [f"{conv['uri']}-{i}" for i in range(len(refs))]
            if metric is bleu:
                bleu.append(ids, realigned, [refs])
            else:
                wer.append(ids, [h.split() for h in realigned],
                           [r.split() for r in refs])
    return (round(float(bleu.summarize("BLEU")), 2),
            round(float(wer.summarize("WER")), 2))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int,
                        default=int(os.environ.get("STAC_QD_EPOCHS", "60")))
    parser.add_argument("--utts", type=int, default=32)
    parser.add_argument("--convs", type=int, default=2)
    parser.add_argument("--utts-per-conv", type=int, default=6)
    parser.add_argument(
        "--grid", default="pause,shas_3_6,shas_5_10",
        help="comma list: pause | shas_<min>_<max> (reference grid "
             "10_15..10_30 scaled to the fixture length)")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--tpu", action="store_true",
                        help="the JAX script's accelerator flag: keeps "
                             "--device")
    args = parser.parse_args(argv)

    import tempfile

    from ...eval.speaker_change import (
        TOLERANCE_GRID,
        evaluate_speaker_change,
        gt_changes_from_manifest,
    )
    from ...serving import STEngine
    from ...tools.exp_quality_delta import _load_split, train_fixture

    workdir = args.workdir or tempfile.mkdtemp(prefix="stac_l7_")
    parts = train_fixture(workdir, args.epochs, args.utts,
                          device=args.device)
    # materialize split_0 (wav files + manifest the conversations reuse)
    _load_split(workdir, args.utts, 0)
    sp = parts["sp"]
    convs, manifest, man_path = build_conversations(
        workdir, n_convs=args.convs, utts_per_conv=args.utts_per_conv)

    engine = STEngine(
        parts["transformer"], parts["cnn"], parts["seq_lin"],
        parts["ctc_lin"], parts["cmvn"], sp,
        beam_size=10, bucket_seconds=(1.0, 2.0, 4.0, 8.0), bf16=False,
        max_decode_tokens=48,
        turn_id=sp.piece_to_id("[turn]"), xt_id=sp.piece_to_id("[xt]"),
        device=args.device,
    )

    # ---- segmentation grid → long_form decode → realign → BLEU/WER ----
    rows = []
    for point in args.grid.split(","):
        point = point.strip()
        if point == "pause":
            kw = {"segmentation": "pause"}
        elif point.startswith("shas_"):
            _, lo, hi = point.split("_")
            kw = {
                "segmentation": "shas",
                "dac_min_segment_length": float(lo),
                "dac_max_segment_length": float(hi),
            }
        else:
            raise SystemExit(f"unknown grid point {point!r}")
        results = []
        for conv in convs:
            r = engine.long_form(conv["wav"], uri=conv["uri"], **kw)
            # keep both marker variants: long_form's merged texts are
            # clean; rebuild the raw stream from per-segment outputs
            r["raw"] = {
                "transcription": " ".join(
                    s["transcription"] for s in r["segments"]),
                "translation": " ".join(
                    s["translation"] for s in r["segments"]),
            }
            results.append(r)
        bleu, wer_v = score_grid_point(convs, manifest, results,
                                       with_markers=False)
        bleu_t, wer_t = score_grid_point(convs, manifest, results,
                                         with_markers=True)
        n_segs = sum(len(r["segments"]) for r in results)
        row = {"grid": point, "segments": n_segs,
               "st_bleu": bleu, "asr_wer": wer_v,
               "st_bleu_with_turns": bleu_t, "asr_wer_with_turns": wer_t}
        rows.append(row)
        print(json.dumps(row), flush=True)

    # ---- speaker-change F1 (ground-truth segmentation leg) -------------
    gt = gt_changes_from_manifest(man_path)
    wavs, uids = [], []
    for uid, entry in sorted(manifest.items()):
        with wave.open(entry["wav"], "rb") as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        wavs.append(pcm.astype(np.float32) / 32768.0)
        uids.append(uid)
    turns = engine.speaker_turns(wavs)
    hyp = {uid: t["turn"] for uid, t in zip(uids, turns)}
    f1_rows = []
    for m in evaluate_speaker_change(gt, hyp, TOLERANCE_GRID):
        d = m.as_dict()
        f1_rows.append({k: round(float(v), 3) for k, v in d.items()})
        print(json.dumps(f1_rows[-1]), flush=True)

    print(json.dumps({
        "metric": "long_form_full_protocol",
        "epochs": args.epochs,
        "grid": rows,
        "speaker_change_f1": f1_rows,
    }))
    return rows, f1_rows


if __name__ == "__main__":
    main()
