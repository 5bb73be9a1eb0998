#!/usr/bin/env python
"""Import a reference (SpeechBrain) checkpoint directory into the
framework's msgpack format (port of ``tools/import_sb_ckpt.py``, same
arguments).

Usage:
    python -m stac_st_tpu_torch.tools.import_sb_ckpt <sb_ckpt_dir> <out_dir>

<sb_ckpt_dir> is an SB Checkpointer save directory containing ``model.ckpt``
(state_dict of ModuleList[CNN, Transformer, seq_lin, ctc_lin] —
ref train_multitask.py:460-471) and optionally ``normalizer.ckpt``.
Writes a framework checkpoint ``<out_dir>/CKPT+imported/`` (model.msgpack
+ normalizer.msgpack + meta.json, byte-equal to the JAX tool's) that
``recipes/inference.py`` and ``STEngine.from_experiment`` load directly —
point ``--pretrained_path`` at the directory whose ``save/`` holds it.
"""

import argparse

from ..interop.sb_import import load_sb_experiment, save_imported


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpt_dir", help="SB checkpoint directory (model.ckpt)")
    ap.add_argument("out_dir", help="output directory for msgpack params")
    args = ap.parse_args(argv)

    loaded = load_sb_experiment(args.ckpt_dir)
    ckpt = save_imported(
        loaded["params"], args.out_dir, cmvn=loaded["cmvn"],
        source=args.ckpt_dir,
    )
    n = sum(x.size for x in _leaves(loaded["params"]))
    print(f"imported {n:,} parameters -> {ckpt}")
    return 0


def _leaves(tree):
    if hasattr(tree, "items"):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
