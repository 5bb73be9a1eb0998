#!/usr/bin/env python3
"""Which operations of the port's recipe run without a deterministic CUDA
implementation, and how far its validation numbers spread between runs.

Run from the repository root on a machine with one CUDA card:

    python3 tools/probe_determinism.py [--runs 3] [--workers 1 4]

It writes the corpus of ``chip_smoke.py``'s recipe phase (seeded audio and
text, a BPE tokenizer) to a temporary directory and runs
``stac_st_tpu_torch.recipes.train_multitask.main`` on the shipped
``transformer_multitask.yaml`` at full width for one epoch with the
teacher-forced validation (no validation search, no evaluation):

1. once under ``torch.use_deterministic_algorithms(True, warn_only=True)``,
   collecting the warnings PyTorch raises for each operation that has no
   deterministic implementation (the operation names itself);
2. then ``--runs`` times as it ships for each loader worker count of
   ``--workers`` (the recipe's host speed perturbation draws its random
   speeds in the loader's threads), each run from the same seed in a
   fresh output folder, printing its validation loss and ACC.

Prints one JSON line: the card (``nvidia-smi`` name and power limit), the
operations named, and each run's numbers with their spread per worker
count.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def one_run(root: str, tok: str, name: str, workers: int = 1) -> dict:
    """One epoch of the recipe; its validation stats."""
    from stac_st_tpu_torch.recipes import train_multitask as R

    stats = {}
    base = R.STTrainer

    class Recorded(base):
        def _validate(self, valid_set, epoch):
            out = super()._validate(valid_set, epoch)
            stats.update({k: float(v) for k, v in out.items()})
            return out

    R.STTrainer = Recorded
    try:
        R.main([os.path.join(ROOT, "recipes", "hparams",
                             "transformer_multitask.yaml"),
                "--device=cuda", f"--data_folder={root}",
                f"--tokenizer_file={tok}",
                f"--output_folder={os.path.join(root, name)}",
                "--train_splits=train", "--dev_splits=dev",
                "--test_splits_4_translations=[]",
                "--test_splits_1_translations=[]",
                "--number_of_epochs=1", "--valid_search_interval=100",
                f"--num_workers={workers}", "--no_eval=True",
                "--n_warmup_steps=10",
                "--turn=5", "--xt=6"])
    finally:
        R.STTrainer = base
    return stats


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--workers", type=int, nargs="+", default=[1, 4])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_determinism: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    out = {"gpu": card()}
    with tempfile.TemporaryDirectory() as root:
        tok, _ = chip_smoke.recipe_corpus(root)
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out["deterministic_run"] = one_run(root, tok, "det")
        torch.use_deterministic_algorithms(False)
        named = sorted({str(w.message).split(" does not have")[0]
                        for w in caught
                        if "deterministic" in str(w.message)})
        out["nondeterministic_ops"] = named
        for w in args.workers:
            runs = [one_run(root, tok, f"w{w}_run{i}", w)
                    for i in range(args.runs)]
            out[f"workers_{w}"] = {
                "runs": runs,
                "spread": {k: max(r[k] for r in runs) - min(r[k] for r in runs)
                           for k in runs[0]}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
