#!/usr/bin/env python3
"""Build the flagship-scale synthetic quality corpus + vocab-5000 tokenizer
(port of ``tools/flagship_corpus.py``: the same files for the same
arguments).

Stage 1 of the flagship quality run: generates a *learnable* tone-TTS
corpus (``stac_st_tpu_torch.data.synth``) big enough to train the
reference's small preset (d256/4h/12+6L, vocab 5000 — the reference's
``ablations/run_m_and_l_size.sh:72-99``) to real held-out generalization,
laid out the way ``stac_st_tpu_torch.recipes.train_multitask`` expects::

    <out>/
      wav/                      all utterance wavs (shared)
      train/data-mixed.json     ASR+ST mixture (the training split)
      dev/data-st.json          validation (same distribution)
      heldout/data-st.json      }  unseen sentences, same lexicon —
      heldout/data-asr.json     }  the generalization test splits
      conversations/            long-form wavs + data-longform.json
      tok/5000_bpe.model        vocab-5000 BPE (reference symbol order)

The BPE trainer stops early when the corpus offers no more merges; the
printed ``vocab`` is the size reached.

Usage: python -m stac_st_tpu_torch.tools.flagship_corpus --out DATA_DIR
           [--train-utts 10000] [--heldout-utts 400] [--dev-utts 96]
"""

import argparse
import json
import os
import shutil
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--train-utts", type=int, default=10000)
    ap.add_argument("--dev-utts", type=int, default=96)
    ap.add_argument("--heldout-utts", type=int, default=400)
    ap.add_argument("--n-words", type=int, default=2000)
    ap.add_argument("--convs", type=int, default=4)
    ap.add_argument("--utts-per-conv", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=5000,
                    help="BPE vocab (flagship preset: 5000; smaller for "
                         "plumbing smokes on tiny corpora)")
    args = ap.parse_args(argv)

    from ..data.synth import (
        build_lexicon,
        make_synth_conversations,
        make_synth_corpus,
        write_mixed_manifest,
    )
    from ..tokenizer import SentencePiece

    out = args.out
    os.makedirs(out, exist_ok=True)
    lex = build_lexicon(args.n_words, seed=0)

    t0 = time.time()
    # distinct seeds + prefixes: dev/heldout sentences are unseen
    splits = {
        "train": (args.train_utts, 0, "tr"),
        "dev": (args.dev_utts, 7001, "dv"),
        "heldout": (args.heldout_utts, 9001, "ho"),
    }
    manifests = {}
    for name, (n, seed, prefix) in splits.items():
        asr, st, joint = make_synth_corpus(
            out, n_utts=n, seed=seed, lexicon=lex, prefix=prefix)
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        paths = {}
        for kind, src in (("asr", asr), ("st", st), ("joint", joint)):
            dst = os.path.join(d, f"data-{kind}.json")
            shutil.move(src, dst)
            paths[kind] = dst
        manifests[name] = paths
        print(f"{name}: {n} utts ({time.time() - t0:.0f}s)", flush=True)

    write_mixed_manifest(
        manifests["train"]["asr"], manifests["train"]["st"],
        os.path.join(out, "train", "data-mixed.json"))

    conv_dir = os.path.join(out, "conversations")
    make_synth_conversations(
        conv_dir, lex, n_convs=args.convs,
        utts_per_conv=args.utts_per_conv, seed=100)
    print(f"conversations: {args.convs} ({time.time() - t0:.0f}s)",
          flush=True)

    tok_dir = os.path.join(out, "tok")
    os.makedirs(tok_dir, exist_ok=True)
    tok = SentencePiece(
        model_dir=tok_dir, vocab_size=args.vocab,
        annotation_train=manifests["train"]["joint"],
        annotation_read="transcription_and_translation",
        model_type="bpe",
        user_defined_symbols="[es],[en],[turn],[xt]",
        bos_id=1, eos_id=2, unk_id=0,
    )
    sp = tok.sp
    ids = {p: sp.piece_to_id(p) for p in ("[es]", "[en]", "[turn]", "[xt]")}
    report = {
        "tokenizer": tok.model_path, "vocab": sp.get_piece_size(),
        "special_ids": ids, "elapsed_s": round(time.time() - t0, 1),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
