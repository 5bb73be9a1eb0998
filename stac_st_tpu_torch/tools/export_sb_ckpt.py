#!/usr/bin/env python
"""Export a framework checkpoint to the reference (SpeechBrain) format
(port of ``tools/export_sb_ckpt.py``, same arguments).

Usage:
    python -m stac_st_tpu_torch.tools.export_sb_ckpt <ckpt_dir> <out_dir> \
        [--template t.ckpt]

<ckpt_dir> is a framework checkpoint directory (``CKPT+*`` holding
``model.msgpack`` + optional ``normalizer.msgpack``, written by either
package). Writes ``model.ckpt`` (+ ``normalizer.ckpt``) under <out_dir> as
torch state_dicts the reference's SB Checkpointer layout expects
(``train_multitask.py:460-471``) — models trained by the port become
loadable by the unchanged reference tooling. ``--template`` merges
non-parameter buffers (``.pe`` tables) from an existing reference
``model.ckpt`` so strict loading works; without it, load with
``strict=False``.
"""

import argparse
import os

import torch

from ..interop.sb_export import export_model_state_dict, export_normalizer_dict
from ..ops.cmvn import CmvnState
from ..training.checkpoint import msgpack_restore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ckpt_dir", help="framework CKPT+* directory")
    ap.add_argument("out_dir", help="output dir for model.ckpt")
    ap.add_argument("--template", default=None,
                    help="reference model.ckpt to copy buffers from")
    args = ap.parse_args(argv)

    with open(os.path.join(args.ckpt_dir, "model.msgpack"), "rb") as f:
        params = msgpack_restore(f.read())

    extra = None
    if args.template:
        tpl = torch.load(args.template, map_location="cpu",
                         weights_only=True)
        extra = {k: v for k, v in tpl.items()
                 if k.endswith(".pe") or ".positional_encoding" in k}

    sd = export_model_state_dict(params, extra=extra)
    os.makedirs(args.out_dir, exist_ok=True)
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
               os.path.join(args.out_dir, "model.ckpt"))
    n = sum(v.size for v in sd.values())
    print(f"exported {n:,} values -> {args.out_dir}/model.ckpt")

    norm_path = os.path.join(args.ckpt_dir, "normalizer.msgpack")
    if os.path.isfile(norm_path):
        with open(norm_path, "rb") as f:
            raw = msgpack_restore(f.read())
        cmvn = CmvnState(**{k: raw[k] for k in ("mean", "std", "count")})
        stats = export_normalizer_dict(cmvn)
        # torch tensors, as the reference saves them (weights_only-safe)
        stats = {
            k: (torch.from_numpy(v.copy()) if hasattr(v, "ndim") else v)
            for k, v in stats.items()
        }
        torch.save(stats, os.path.join(args.out_dir, "normalizer.ckpt"))
        print(f"exported normalizer -> {args.out_dir}/normalizer.ckpt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
