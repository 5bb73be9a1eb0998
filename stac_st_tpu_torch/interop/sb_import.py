"""Import reference (SpeechBrain/PyTorch) checkpoints (port of
``stac_st_tpu/interop/sb_import.py``): the state dict becomes the JAX
engine's parameter tree, the layout the port writes its own ``model``
checkpoints in, so ``interop.from_jax.load_jax_params`` loads it into the
port's modules and :func:`save_imported` writes it as a checkpoint that
``STEngine.from_experiment`` / ``from_saved_experiment`` load.

The reference checkpoints a ``torch.nn.ModuleList([CNN, Transformer,
seq_lin, ctc_lin])`` via the SB Checkpointer (``train_multitask.py:460-471``,
``transformer_multitask.yaml:219-220``), i.e. ``model.ckpt`` holds a flat
state_dict with these prefixes:

- ``0.`` — ``ConvolutionFrontEnd``: ``convblock_{b}.convs.conv_{l}.conv.*``
  (torch conv weight ``(out, in, kF, kT)`` — SB's Conv2d transposes
  ``(B,T,F,C) → (B,C,F,T)`` before nn.Conv2d) and
  ``convblock_{b}.convs.norm_{l}.norm.*`` (LayerNorm over trailing
  ``(F, C)``).
- ``1.`` — ``TransformerMultiTask`` (``TransformerMultiTask.py:130-142``):
  ``custom_src_module.0.w.*`` (SB Linear wraps nn.Linear as ``.w``),
  ``custom_tgt_module.0.emb.Embedding.weight`` (NormalizedEmbedding),
  ``encoder.layers.{i}.self_att.att.*`` (SB MHA wraps nn.MultiheadAttention
  as ``.att``: fused ``in_proj_weight (3d, d)`` + ``out_proj``),
  ``encoder.layers.{i}.pos_ffn.ffn.{0,3}.*`` (Sequential Linear/act/drop/
  Linear), ``norm{1,2}.norm.*``, final ``encoder.norm.norm.*``; decoder
  mirrors with ``self_attn`` / ``mutihead_attn`` (SB's historical spelling;
  ``multihead_attn`` also accepted) and ``norm{1,2,3}``.
- ``2.`` / ``3.`` — seq_lin / ctc_lin (SB Linear: ``w.weight (V, d)``).

torch Linear computes ``x @ W.T`` with ``W (out, in)``; the tree stores
``kernel (in, out)`` as flax's Dense does — so every weight matrix
transposes on import. All
layer counts / dims are inferred from the state_dict itself.

``normalizer.ckpt`` (SB ``InputNormalization._save``) carries
``glob_mean`` / ``glob_std`` / ``count`` → the port's
:class:`~stac_st_tpu_torch.ops.cmvn.CmvnState`.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.cmvn import CmvnState
from ..training.checkpoint import msgpack_serialize

__all__ = [
    "import_model_state_dict",
    "import_normalizer_dict",
    "load_sb_experiment",
    "save_imported",
]


def _np(t) -> np.ndarray:
    """torch.Tensor / array-like → float32 numpy (host)."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd: Mapping, key: str) -> Dict[str, np.ndarray]:
    """SB/torch Linear (out, in) → flax Dense {kernel (in, out), bias}."""
    out = {"kernel": _np(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _layernorm(sd: Mapping, key: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _mha(sd: Mapping, key: str) -> Dict[str, Any]:
    """nn.MultiheadAttention (fused in_proj) → my q/k/v/out projections."""
    w = _np(sd[f"{key}.in_proj_weight"])  # (3d, d), rows [q; k; v]
    b = _np(sd[f"{key}.in_proj_bias"])
    d = w.shape[1]
    qw, kw, vw = w[:d], w[d : 2 * d], w[2 * d :]
    qb, kb, vb = b[:d], b[d : 2 * d], b[2 * d :]
    return {
        "q_proj": {"kernel": qw.T, "bias": qb},
        "k_proj": {"kernel": kw.T, "bias": kb},
        "v_proj": {"kernel": vw.T, "bias": vb},
        "out_proj": _linear(sd, f"{key}.out_proj"),
    }


def _count_layers(sd: Mapping, prefix: str, probe: str) -> int:
    n = 0
    while any(k.startswith(f"{prefix}{n}{probe}") for k in sd):
        n += 1
    return n


def _import_cnn(sd: Mapping, prefix: str = "0.") -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    b = 0
    while f"{prefix}convblock_{b}.convs.conv_0.conv.weight" in sd:
        l = 0
        while f"{prefix}convblock_{b}.convs.conv_{l}.conv.weight" in sd:
            base = f"{prefix}convblock_{b}.convs"
            w = _np(sd[f"{base}.conv_{l}.conv.weight"])  # (out, in, kF, kT)
            conv = {"kernel": np.transpose(w, (3, 2, 1, 0))}  # (kT, kF, in, out)
            if f"{base}.conv_{l}.conv.bias" in sd:
                conv["bias"] = _np(sd[f"{base}.conv_{l}.conv.bias"])
            params[f"block{b}_conv{l}"] = conv
            if f"{base}.norm_{l}.norm.weight" in sd:
                params[f"block{b}_norm{l}"] = _layernorm(sd, f"{base}.norm_{l}.norm")
            l += 1
        b += 1
    if not params:
        raise ValueError(f"no ConvolutionFrontEnd params under prefix {prefix!r}")
    return params


def _enc_layer(sd: Mapping, base: str) -> Dict[str, Any]:
    return {
        "self_attn": _mha(sd, f"{base}.self_att.att"),
        "ffn": {
            "fc1": _linear(sd, f"{base}.pos_ffn.ffn.0"),
            "fc2": _linear(sd, f"{base}.pos_ffn.ffn.3"),
        },
        "norm1": _layernorm(sd, f"{base}.norm1.norm"),
        "norm2": _layernorm(sd, f"{base}.norm2.norm"),
    }


def _dec_layer(sd: Mapping, base: str) -> Dict[str, Any]:
    cross_key = f"{base}.mutihead_attn.att"  # SB spelling
    if f"{cross_key}.in_proj_weight" not in sd:
        cross_key = f"{base}.multihead_attn.att"
    return {
        "self_attn": _mha(sd, f"{base}.self_attn.att"),
        "cross_attn": _mha(sd, cross_key),
        "ffn": {
            "fc1": _linear(sd, f"{base}.pos_ffn.ffn.0"),
            "fc2": _linear(sd, f"{base}.pos_ffn.ffn.3"),
        },
        "norm1": _layernorm(sd, f"{base}.norm1.norm"),
        "norm2": _layernorm(sd, f"{base}.norm2.norm"),
        "norm3": _layernorm(sd, f"{base}.norm3.norm"),
    }


def _import_transformer(sd: Mapping, prefix: str = "1.") -> Dict[str, Any]:
    if f"{prefix}custom_src_module.0.w.weight" not in sd:
        raise ValueError(
            f"no TransformerMultiTask params under prefix {prefix!r}"
        )
    if any(re.search(r"pos_bias|linear_pos|rel", k) for k in sd):
        raise NotImplementedError(
            "RelPosMHAXL checkpoints are not supported by the importer yet"
        )
    params: Dict[str, Any] = {
        "src_proj": _linear(sd, f"{prefix}custom_src_module.0.w"),
        "tgt_embed": {
            "embed": {
                "embedding": _np(
                    sd[f"{prefix}custom_tgt_module.0.emb.Embedding.weight"]
                )
            }
        },
    }
    n_enc = _count_layers(sd, f"{prefix}encoder.layers.", ".self_att")
    n_dec = _count_layers(sd, f"{prefix}decoder.layers.", ".self_attn")
    encoder = {
        f"layer_{i}": _enc_layer(sd, f"{prefix}encoder.layers.{i}")
        for i in range(n_enc)
    }
    encoder["final_norm"] = _layernorm(sd, f"{prefix}encoder.norm.norm")
    decoder = {
        f"layer_{i}": _dec_layer(sd, f"{prefix}decoder.layers.{i}")
        for i in range(n_dec)
    }
    decoder["final_norm"] = _layernorm(sd, f"{prefix}decoder.norm.norm")
    params["encoder"] = encoder
    params["decoder"] = decoder
    return params


def import_model_state_dict(state_dict: Mapping) -> Dict[str, Any]:
    """Flat SB ``model.ckpt`` state_dict → the JAX engine's params tree
    ``{"CNN": {"params": …}, "Transformer": …, "seq_lin": …, "ctc_lin": …}``.

    Unknown keys are ignored only if they are buffers (``.pe`` positional
    tables); unexpected *parameter* keys raise, so silent drops can't
    happen.
    """
    consumed = _ImportTracker(state_dict)
    sd = consumed  # mapping view that records key usage
    params = {
        "CNN": {"params": _import_cnn(sd)},
        "Transformer": {"params": _import_transformer(sd)},
        "seq_lin": {"params": {"linear": _linear(sd, "2.w")}},
    }
    if "3.w.weight" in state_dict:
        params["ctc_lin"] = {"params": {"linear": _linear(sd, "3.w")}}
    leftovers = [
        k for k in state_dict
        if k not in consumed.used and not _is_buffer(k)
    ]
    if leftovers:
        raise ValueError(f"unmapped reference parameters: {leftovers[:8]}")
    return params


def _is_buffer(key: str) -> bool:
    return key.endswith(".pe") or ".positional_encoding" in key


class _ImportTracker(dict):
    """Mapping proxy that records which keys were read."""

    def __init__(self, base: Mapping):
        super().__init__(base)
        self.used = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)


def import_normalizer_dict(stats: Mapping) -> CmvnState:
    """SB ``InputNormalization`` statistics dict → :class:`CmvnState`
    (fp32 host tensors)."""
    def f32(x) -> torch.Tensor:
        return torch.from_numpy(np.array(_np(x), np.float32))

    return CmvnState(mean=f32(stats["glob_mean"]), std=f32(stats["glob_std"]),
                     count=f32(float(_np(stats.get("count", 0)).item())))


def load_sb_experiment(ckpt_dir: str) -> Dict[str, Any]:
    """Load a reference SB checkpoint directory (``model.ckpt`` +
    optional ``normalizer.ckpt``) → {"params": tree, "cmvn": CmvnState|None}.

    Checkpoints are loaded with ``weights_only=True`` — never unpickles
    arbitrary objects.
    """
    model_path = os.path.join(ckpt_dir, "model.ckpt")
    state_dict = torch.load(model_path, map_location="cpu", weights_only=True)
    out: Dict[str, Any] = {
        "params": import_model_state_dict(state_dict), "cmvn": None
    }
    norm_path = os.path.join(ckpt_dir, "normalizer.ckpt")
    if os.path.isfile(norm_path):
        stats = torch.load(norm_path, map_location="cpu", weights_only=True)
        out["cmvn"] = import_normalizer_dict(stats)
    return out


def save_imported(params: Dict[str, Any], out_dir: str,
                  cmvn: Optional[Any] = None,
                  source: Optional[str] = None) -> str:
    """Write imported params as a FIRST-CLASS framework checkpoint.

    Creates ``<out_dir>/CKPT+imported/`` holding ``model.msgpack``
    (+ ``normalizer.msgpack``) and ``meta.json`` — the exact layout
    ``training/checkpoint.py`` saves (byte-equal to the JAX package's
    ``save_imported``) and everything downstream loads, so pointing
    ``pretrained_path`` at a directory whose ``save/`` contains this
    checkpoint makes ``recipes/inference.py`` and
    ``STEngine.from_experiment`` consume reference weights with NO extra
    wiring.

    Returns the checkpoint directory path.
    """
    import json as _json

    ckpt_dir = os.path.join(out_dir, "CKPT+imported")
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "model.msgpack"), "wb") as f:
        f.write(msgpack_serialize(params))
    if cmvn is not None:
        with open(os.path.join(ckpt_dir, "normalizer.msgpack"), "wb") as f:
            f.write(msgpack_serialize(
                {"mean": cmvn.mean, "std": cmvn.std, "count": cmvn.count}))
    meta = {"imported_from": source or "speechbrain", "ACC": 1.1,
            "unixtime": 0.0}
    # ACC 1.1 mirrors the reference's collapse-to-averaged trick
    # (train_multitask.py:450-458): an imported checkpoint always wins
    # top-k selection, so averaging over the kept set returns it alone.
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        _json.dump(meta, f, indent=2)
    return ckpt_dir
