"""Load the JAX reference's parameters into the port's modules.

The JAX engine holds ``{"CNN", "Transformer", "seq_lin", "ctc_lin"}``
flax parameter trees (each optionally wrapped in ``{"params": ...}``);
given as nested dicts of numpy arrays, they load here with these layout
changes:

* Dense kernel (in, out) -> ``nn.Linear`` weight (out, in);
* Conv kernel HWIO (k_time, k_freq, in, out) -> ``nn.Conv2d`` weight
  (out, in, k_time, k_freq), H = time and W = freq as in the reference;
* q/k/v kernels -> one ``in_proj`` (3·d, d), concatenated in the order of
  the reference's ``_fused_qkv`` (q | k | v);
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``.

Strict: a key of the tree that nothing consumed, or a port parameter that
nothing set, raises. A transformer tree carries neither its head count nor
its layer-norm placement (a post-LN and a pre-LN model have the same keys),
so loading one also takes the JAX module's settings and refuses any that
the port cannot run (``PORT_SETTINGS``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models import ConvolutionFrontEnd, LinearHead, TransformerMultiTask
from ..models.transformer import MultiHeadAttention
from ..ops.cmvn import CmvnState

__all__ = ["load_jax_params", "cmvn_from_jax", "PORT_SETTINGS"]

# The JAX ``TransformerMultiTask`` settings the port's model computes; any
# other value loads the same keys into another network. ``nhead`` must
# also equal the port module's own.
PORT_SETTINGS = {
    "normalize_before": True,
    "causal": False,
    "encoder_module": "transformer",
    "attention_type": "regularMHA",
    "positional_encoding": "fixed_abs_sine",
}
_MISSING = object()


def _flatten(node: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(node, Mapping):
        if set(node) == {"params"}:
            node = node["params"]
        for key, child in node.items():
            _flatten(child, f"{prefix}/{key}" if prefix else str(key), out)
    else:
        out[prefix] = node


class _Loader:
    def __init__(self, flat: Dict[str, Any]):
        self.flat = flat
        self.used: set = set()
        self.assigned: set = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.flat:
            raise KeyError(f"JAX parameter tree has no {key!r}")
        self.used.add(key)
        return np.asarray(self.flat[key], dtype=np.float32)

    def assign(self, param: torch.Tensor, value: np.ndarray, key: str):
        if tuple(param.shape) != value.shape:
            raise ValueError(f"{key}: shape {value.shape} does not fit "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value, np.float32)))
        self.assigned.add(id(param))

    def linear(self, lin: nn.Linear, key: str) -> None:
        self.assign(lin.weight, self.take(f"{key}/kernel").T, key)
        if lin.bias is not None:
            self.assign(lin.bias, self.take(f"{key}/bias"), key)

    def layernorm(self, ln: nn.LayerNorm, key: str) -> None:
        self.assign(ln.weight, self.take(f"{key}/scale"), key)
        self.assign(ln.bias, self.take(f"{key}/bias"), key)

    def mha(self, mha: MultiHeadAttention, key: str) -> None:
        parts = ("q_proj", "k_proj", "v_proj")
        w = np.concatenate([self.take(f"{key}/{p}/kernel") for p in parts],
                           axis=1)
        b = np.concatenate([self.take(f"{key}/{p}/bias") for p in parts])
        self.assign(mha.in_proj.weight, w.T, key)
        self.assign(mha.in_proj.bias, b, key)
        self.linear(mha.out_proj, f"{key}/out_proj")

    def ffn(self, ffn, key: str) -> None:
        self.linear(ffn.fc1, f"{key}/fc1")
        self.linear(ffn.fc2, f"{key}/fc2")


def load_jax_params(params: Mapping,
                    cnn: Optional[ConvolutionFrontEnd] = None,
                    transformer: Optional[TransformerMultiTask] = None,
                    seq_lin: Optional[LinearHead] = None,
                    ctc_lin: Optional[LinearHead] = None,
                    settings: Any = None) -> None:
    """Copy the JAX engine's parameter tree into the given port modules.
    Every key of ``params`` must land in one of them.

    ``settings`` describes the JAX transformer the tree came from: the flax
    ``TransformerMultiTask`` itself (read by attribute) or a mapping with
    the same field names. It is required with ``transformer``; a field that
    differs from ``PORT_SETTINGS``, or an ``nhead`` other than the port
    module's, raises ``ValueError`` naming the field."""
    if transformer is not None:
        check_settings(settings, transformer)
    flat: Dict[str, Any] = {}
    _flatten(params, "", flat)
    ld = _Loader(flat)
    if cnn is not None:
        _load_cnn(ld, cnn)
    if transformer is not None:
        _load_transformer(ld, transformer)
    heads = {"seq_lin": seq_lin, "ctc_lin": ctc_lin}
    for name, head in heads.items():
        if head is not None:
            ld.linear(head.linear, f"{name}/linear")

    unused = sorted(set(flat) - ld.used)
    if unused:
        raise KeyError(f"JAX parameters not consumed: {unused}")
    modules = [m for m in (cnn, transformer, seq_lin, ctc_lin)
               if m is not None]
    unset = [n for m in modules for n, p in m.named_parameters()
             if id(p) not in ld.assigned]
    if unset:
        raise KeyError(f"port parameters left unset: {unset}")


def check_settings(settings: Any, transformer: TransformerMultiTask) -> None:
    """Raise unless the JAX transformer described by ``settings`` is one
    the port's ``transformer`` computes."""
    if settings is None:
        raise ValueError("load_jax_params: a transformer tree needs the JAX "
                         "module's settings (settings=...)")
    want = {**PORT_SETTINGS, "nhead": transformer.nhead}
    get = (settings.get if isinstance(settings, Mapping)
           else lambda f, d: getattr(settings, f, d))
    for field, value in want.items():
        got = get(field, _MISSING)
        if got is _MISSING:
            raise ValueError(f"JAX transformer settings lack {field!r}")
        if got != value:
            raise ValueError(f"JAX transformer {field}={got!r}: the port "
                             f"runs only {field}={value!r}")


def _load_cnn(ld: _Loader, cnn: ConvolutionFrontEnd) -> None:
    for name, mod in cnn.layers.items():
        key = f"CNN/{name}"
        if isinstance(mod, nn.Conv2d):
            ld.assign(mod.weight,
                      ld.take(f"{key}/kernel").transpose(3, 2, 0, 1), key)
            ld.assign(mod.bias, ld.take(f"{key}/bias"), key)
        else:
            ld.layernorm(mod, key)


def _load_transformer(ld: _Loader, tr: TransformerMultiTask) -> None:
    ld.linear(tr.src_proj, "Transformer/src_proj")
    ld.assign(tr.tgt_embed.embed.weight,
              ld.take("Transformer/tgt_embed/embed/embedding"),
              "Transformer/tgt_embed")
    for side in ("encoder", "decoder"):
        stack = getattr(tr, side)
        for i, layer in enumerate(stack.layers):
            key = f"Transformer/{side}/layer_{i}"
            ld.mha(layer.self_attn, f"{key}/self_attn")
            if side == "decoder":
                ld.mha(layer.cross_attn, f"{key}/cross_attn")
                ld.layernorm(layer.norm3, f"{key}/norm3")
            ld.ffn(layer.ffn, f"{key}/ffn")
            ld.layernorm(layer.norm1, f"{key}/norm1")
            ld.layernorm(layer.norm2, f"{key}/norm2")
        ld.layernorm(stack.final_norm, f"Transformer/{side}/final_norm")


def cmvn_from_jax(state: Sequence) -> CmvnState:
    """A JAX ``CmvnState`` (mean, std, count arrays) as the port's."""
    mean, std, count = (torch.from_numpy(np.array(x, np.float32))
                        for x in state)
    return CmvnState(mean=mean, std=std, count=count)
