"""Carry parameters between the JAX reference's layout and the port's.

The JAX engine holds ``{"CNN", "Transformer", "seq_lin", "ctc_lin"}``
flax parameter trees (each optionally wrapped in ``{"params": ...}``);
given as nested dicts of numpy arrays, they load here with these layout
changes:

* Dense kernel (in, out) -> ``nn.Linear`` weight (out, in);
* Conv kernel HWIO (k_time, k_freq, in, out) -> ``nn.Conv2d`` weight
  (out, in, k_time, k_freq), H = time and W = freq as in the reference;
* q/k/v kernels -> one ``in_proj`` (3·d, d), concatenated in the order of
  the reference's ``_fused_qkv`` (q | k | v);
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* the Conformer's depthwise Conv kernel (k, 1, d) -> ``nn.Conv1d``
  weight (d, 1, k) (both cross-correlations: the taps are not flipped);
  relative-position attention's ``pos_proj`` (no bias), ``u_bias`` and
  ``v_bias`` (H, Dh) as they are;
* a quantized tree (the reference's ``quantize_decode_weights``: an int8
  ``kernel`` beside its fp32 ``kernel_scale``) loads into port modules
  quantized the same way (``utils.quantize.quantize_decode_weights``
  first): the int8 values, transposed, and the scales as they are.

Strict: a key of the tree that nothing consumed, or a port parameter that
nothing set, raises. A transformer tree carries neither its head count nor
its layer-norm placement (a post-LN and a pre-LN model have the same keys),
so loading one also takes the JAX module's settings and requires the port
module to compute the same network (``check_settings``).

``to_jax_params`` is the inverse: the port's modules as the JAX tree (the
same key set, each module under ``{"params": ...}``, numpy fp32 in the JAX
layouts, int8 kernels and their scales for quantized modules). The port
writes its ``model`` checkpoints in that layout, so each package reads the
other's.

``optax_opt_tree`` / ``optax_opt_fields`` write and read the JAX trainer's
optimizer state (its ``opt`` checkpoint tree) as
``flax.serialization.to_state_dict`` lays it out for the chain of
``stac_st_tpu.training.step.make_optimizer``::

    MultiSteps (accumulation > 1: mini_step, gradient_step,
                inner_opt_state, acc_grads, skip_state)
      (0: apply_if_finite (patience > 0: notfinite_count, last_finite,
                           total_notfinite, inner_state)
            (0: clip_by_global_norm (if clipping): {}
             next: adam(w) at lr 1 (0: count, mu, nu; 1: {}; 2: {} for adamw)),
       1: scale_by_schedule (count))

The moment and accumulator trees are in the parameters' JAX layout; the
trainer maps them from and to its flat vectors through the same mapping
as the parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models import ConvolutionFrontEnd, LinearHead, TransformerMultiTask
from ..models.conformer import ConformerEncoderLayer
from ..models.relpos import RelPosMultiHeadAttention
from ..models.settings import check_model, require
from ..models.transformer import MultiHeadAttention
from ..ops.cmvn import CmvnState
from ..utils.quantize import CrossInProjInt8, Int8Linear

__all__ = ["load_jax_params", "to_jax_params", "cmvn_from_jax",
           "check_settings", "optax_opt_tree", "optax_opt_fields"]

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

    def take_int8(self, key: str) -> np.ndarray:
        if key not in self.flat:
            raise KeyError(f"JAX parameter tree has no {key!r}")
        value = np.asarray(self.flat[key])
        if value.dtype != np.int8:
            raise ValueError(f"{key}: {value.dtype}, expected an int8 "
                             "kernel for a quantized port module")
        self.used.add(key)
        return value

    def assign(self, param: torch.Tensor, value: np.ndarray, key: str):
        if tuple(param.shape) != value.shape:
            raise ValueError(f"{key}: shape {value.shape} does not fit "
                             f"{tuple(param.shape)}")
        dtype = np.int8 if param.dtype == torch.int8 else np.float32
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value, dtype)))
        self.assigned.add(id(param))

    def linear(self, lin: nn.Module, key: str) -> None:
        if isinstance(lin, Int8Linear):
            self.assign(lin.weight, self.take_int8(f"{key}/kernel").T, key)
            self.assign(lin.scale, self.take(f"{key}/kernel_scale"), key)
        elif f"{key}/kernel_scale" in self.flat:
            raise ValueError(f"{key}: an int8 kernel for a float port "
                             "module (quantize the port's modules first: "
                             "utils.quantize.quantize_decode_weights)")
        else:
            self.assign(lin.weight, self.take(f"{key}/kernel").T, key)
        if lin.bias is not None:
            self.assign(lin.bias, self.take(f"{key}/bias"), key)

    def layernorm(self, ln: nn.LayerNorm, key: str) -> None:
        self.assign(ln.weight, self.take(f"{key}/scale"), key)
        self.assign(ln.bias, self.take(f"{key}/bias"), key)

    def mha(self, mha: MultiHeadAttention, key: str) -> None:
        parts = ("q_proj", "k_proj", "v_proj")
        ip = mha.in_proj
        if isinstance(ip, CrossInProjInt8):  # int8 q, float k/v
            self.linear(ip.q, f"{key}/q_proj")
            parts, ip = parts[1:], ip.kv
        take = self.take
        if isinstance(ip, Int8Linear):
            take = self.take_int8
            self.assign(ip.scale, np.concatenate(
                [self.take(f"{key}/{p}/kernel_scale") for p in parts]), key)
        w = np.concatenate([take(f"{key}/{p}/kernel") for p in parts],
                           axis=1)
        b = np.concatenate([self.take(f"{key}/{p}/bias") for p in parts])
        self.assign(ip.weight, w.T, key)
        self.assign(ip.bias, b, key)
        self.linear(mha.out_proj, f"{key}/out_proj")

    def ffn(self, ffn, key: str) -> None:
        self.linear(ffn.fc1, f"{key}/fc1")
        self.linear(ffn.fc2, f"{key}/fc2")

    def attention(self, attn: nn.Module, key: str) -> None:
        """Regular or relative-position self-attention."""
        self.mha(attn, key)
        if isinstance(attn, RelPosMultiHeadAttention):
            self.linear(attn.pos_proj, f"{key}/pos_proj")
            for name in ("u_bias", "v_bias"):
                self.assign(getattr(attn, name), self.take(f"{key}/{name}"),
                            f"{key}/{name}")


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
    the same field names (a port module describes itself the same way).
    It is required with ``transformer``; see ``check_settings`` for what
    must agree."""
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
    unset += [f"{n}.{b}" for m in modules for n, q in m.named_modules()
              if isinstance(q, Int8Linear) for b, t in q.named_buffers()
              if t is not None and id(t) not in ld.assigned]
    if unset:
        raise KeyError(f"port parameters left unset: {unset}")


# the JAX module's fields that change what a tree computes without
# changing its keys (or, for the encoder's kind, that name the keys);
# ``causal`` and ``kernel_size`` act only in a Conformer
_SETTINGS = ("nhead", "normalize_before", "encoder_module", "attention_type")
_CONFORMER_SETTINGS = ("causal", "kernel_size")


def check_settings(settings: Any, transformer: TransformerMultiTask) -> None:
    """Raise ``ValueError`` naming the field unless the JAX transformer
    described by ``settings`` is the network the port's ``transformer``
    computes: an ``attention_type`` and ``encoder_module`` the JAX
    package runs, and the same ``nhead``, ``normalize_before``,
    ``encoder_module`` and ``attention_type`` (and for a Conformer the same
    ``causal`` and ``kernel_size``). ``positional_encoding`` is read by
    neither package; the activations are callables of either package and
    are not compared."""
    if settings is None:
        raise ValueError("load_jax_params: a transformer tree needs the JAX "
                         "module's settings (settings=...)")
    get = (settings.get if isinstance(settings, Mapping)
           else lambda f, d: getattr(settings, f, d))

    def field(name):
        got = get(name, _MISSING)
        if got is _MISSING:
            raise ValueError(f"JAX transformer settings lack {name!r}")
        return got

    owner = "JAX transformer"
    check_model(owner, field)
    names = _SETTINGS
    if transformer.encoder_module == "conformer":
        names += _CONFORMER_SETTINGS
    for name in names:
        require(owner, name, field(name), getattr(transformer, name))


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
            if isinstance(layer, ConformerEncoderLayer):
                _load_conformer_layer(ld, layer, key)
                continue
            ld.attention(layer.self_attn, f"{key}/self_attn")
            if side == "decoder":
                ld.mha(layer.cross_attn, f"{key}/cross_attn")
                ld.layernorm(layer.norm3, f"{key}/norm3")
            ld.ffn(layer.ffn, f"{key}/ffn")
            ld.layernorm(layer.norm1, f"{key}/norm1")
            ld.layernorm(layer.norm2, f"{key}/norm2")
        if hasattr(stack, "final_norm"):  # a Conformer stack has none
            ld.layernorm(stack.final_norm, f"Transformer/{side}/final_norm")


def _load_conformer_layer(ld: _Loader, layer: ConformerEncoderLayer,
                          key: str) -> None:
    ld.ffn(layer.ffn1, f"{key}/ffn1")
    ld.ffn(layer.ffn2, f"{key}/ffn2")
    ld.attention(layer.attn, f"{key}/attn")
    for name in ("norm_ffn1", "norm_attn", "norm_ffn2", "final_norm"):
        ld.layernorm(getattr(layer, name), f"{key}/{name}")
    conv, ck = layer.conv, f"{key}/conv"
    ld.layernorm(conv.norm, f"{ck}/norm")
    ld.linear(conv.pw1, f"{ck}/pw1")
    ld.assign(conv.depthwise.weight,
              ld.take(f"{ck}/depthwise/kernel").transpose(2, 1, 0),
              f"{ck}/depthwise")
    ld.assign(conv.depthwise.bias, ld.take(f"{ck}/depthwise/bias"),
              f"{ck}/depthwise")
    ld.layernorm(conv.conv_norm, f"{ck}/conv_norm")
    ld.linear(conv.pw2, f"{ck}/pw2")


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU parameter's memory)."""
    dtype = torch.int8 if t.dtype == torch.int8 else torch.float32
    return np.array(t.detach().to("cpu", dtype).numpy(), order="C")


def _dense(lin: nn.Module) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(lin.weight).T.copy()}
    if isinstance(lin, Int8Linear):
        out["kernel_scale"] = _np(lin.scale)
    if lin.bias is not None:
        out["bias"] = _np(lin.bias)
    return out


def _norm(ln: nn.LayerNorm) -> Dict[str, np.ndarray]:
    return {"scale": _np(ln.weight), "bias": _np(ln.bias)}


def _mha(mha: MultiHeadAttention) -> Dict[str, Any]:
    names, ip, out = ("q", "k", "v"), mha.in_proj, {}
    if isinstance(ip, CrossInProjInt8):  # int8 q, float k/v
        out["q_proj"] = _dense(ip.q)
        names, ip = names[1:], ip.kv
    w = _np(ip.weight).T  # (d, n·d): q | k | v, or k | v
    b = _np(ip.bias)
    d = w.shape[0]
    for i, name in enumerate(names):
        sl = slice(i * d, (i + 1) * d)
        out[f"{name}_proj"] = {"kernel": w[:, sl].copy(),
                               "bias": b[sl].copy()}
        if isinstance(ip, Int8Linear):
            out[f"{name}_proj"]["kernel_scale"] = _np(ip.scale)[sl].copy()
    out["out_proj"] = _dense(mha.out_proj)
    return out


def _attention(attn: nn.Module) -> Dict[str, Any]:
    out = _mha(attn)
    if isinstance(attn, RelPosMultiHeadAttention):
        out["pos_proj"] = _dense(attn.pos_proj)
        out["u_bias"] = _np(attn.u_bias)
        out["v_bias"] = _np(attn.v_bias)
    return out


def _conformer_layer(layer: ConformerEncoderLayer) -> Dict[str, Any]:
    conv = layer.conv
    entry = {"ffn1": {"fc1": _dense(layer.ffn1.fc1),
                      "fc2": _dense(layer.ffn1.fc2)},
             "ffn2": {"fc1": _dense(layer.ffn2.fc1),
                      "fc2": _dense(layer.ffn2.fc2)},
             "attn": _attention(layer.attn),
             "conv": {"norm": _norm(conv.norm), "pw1": _dense(conv.pw1),
                      "depthwise": {
                          "kernel": _np(conv.depthwise.weight).transpose(
                              2, 1, 0).copy(),
                          "bias": _np(conv.depthwise.bias)},
                      "conv_norm": _norm(conv.conv_norm),
                      "pw2": _dense(conv.pw2)}}
    for name in ("norm_ffn1", "norm_attn", "norm_ffn2", "final_norm"):
        entry[name] = _norm(getattr(layer, name))
    return entry


def _transformer_tree(tr: TransformerMultiTask) -> Dict[str, Any]:
    tree: Dict[str, Any] = {
        "src_proj": _dense(tr.src_proj),
        "tgt_embed": {"embed": {"embedding": _np(tr.tgt_embed.embed.weight)}},
    }
    for side in ("encoder", "decoder"):
        stack = getattr(tr, side)
        layers: Dict[str, Any] = {}
        if hasattr(stack, "final_norm"):  # a Conformer stack has none
            layers["final_norm"] = _norm(stack.final_norm)
        for i, layer in enumerate(stack.layers):
            if isinstance(layer, ConformerEncoderLayer):
                layers[f"layer_{i}"] = _conformer_layer(layer)
                continue
            entry = {"self_attn": _attention(layer.self_attn),
                     "ffn": {"fc1": _dense(layer.ffn.fc1),
                             "fc2": _dense(layer.ffn.fc2)},
                     "norm1": _norm(layer.norm1),
                     "norm2": _norm(layer.norm2)}
            if side == "decoder":
                entry["cross_attn"] = _mha(layer.cross_attn)
                entry["norm3"] = _norm(layer.norm3)
            layers[f"layer_{i}"] = entry
        tree[side] = layers
    return tree


def to_jax_params(cnn: Optional[ConvolutionFrontEnd] = None,
                  transformer: Optional[TransformerMultiTask] = None,
                  seq_lin: Optional[LinearHead] = None,
                  ctc_lin: Optional[LinearHead] = None) -> Dict[str, Any]:
    """The given port modules as the JAX engine's parameter tree
    ``{"CNN": {"params": ...}, "Transformer": ..., "seq_lin": ...,
    "ctc_lin": ...}`` of fp32 numpy arrays: the inverse of
    ``load_jax_params`` (Linear weight (out, in) -> kernel (in, out); Conv2d
    (out, in, k_time, k_freq) -> HWIO; ``in_proj`` -> q/k/v)."""
    tree: Dict[str, Any] = {}
    if cnn is not None:
        tree["CNN"] = {"params": {
            name: ({"kernel": _np(mod.weight).transpose(2, 3, 1, 0).copy(),
                    "bias": _np(mod.bias)}
                   if isinstance(mod, nn.Conv2d) else _norm(mod))
            for name, mod in cnn.layers.items()}}
    if transformer is not None:
        tree["Transformer"] = {"params": _transformer_tree(transformer)}
    for name, head in (("seq_lin", seq_lin), ("ctc_lin", ctc_lin)):
        if head is not None:
            tree[name] = {"params": {"linear": _dense(head.linear)}}
    return tree


def cmvn_from_jax(state: Sequence) -> CmvnState:
    """A JAX ``CmvnState`` (mean, std, count arrays) as the port's."""
    mean, std, count = (torch.from_numpy(np.array(x, np.float32))
                        for x in state)
    return CmvnState(mean=mean, std=std, count=count)


def _i32(x) -> np.ndarray:
    return np.asarray(int(x), np.int32)


def optax_opt_tree(mu: Any, nu: Any, *, count: int, sched_count: int,
                   kind: str = "adamw", clip: bool = False,
                   patience: int = 0, notfinite: int = 0,
                   total_notfinite: int = 0, accum: int = 1,
                   mini_step: int = 0, acc: Any = None) -> Dict[str, Any]:
    """The optax state dict of the JAX trainer's optimizer chain (see the
    module note) holding these values; ``mu``, ``nu`` and ``acc`` are
    parameter-layout trees. ``count`` counts the applied updates,
    ``sched_count`` the attempts (applied or skipped)."""
    adam = {"count": _i32(count), "mu": mu, "nu": nu}
    core = {"0": adam, "1": {}, "2": {}} if kind == "adamw" else \
        {"0": adam, "1": {}}
    inner = {"0": {}, "1": core} if clip else {"0": core}
    if patience:
        inner = {"notfinite_count": _i32(notfinite),
                 "last_finite": np.asarray(int(notfinite) == 0),
                 "total_notfinite": _i32(total_notfinite),
                 "inner_state": inner}
    tree = {"0": inner, "1": {"count": _i32(sched_count)}}
    if accum > 1:
        tree = {"mini_step": _i32(mini_step),
                "gradient_step": _i32(sched_count),
                "inner_opt_state": tree, "acc_grads": acc,
                "skip_state": {}}
    return tree


def optax_opt_fields(raw: Mapping, *, kind: str = "adamw",
                     clip: bool = False, patience: int = 0,
                     accum: int = 1) -> Dict[str, Any]:
    """The values ``optax_opt_tree`` writes, read from a checkpoint's
    ``opt`` tree of the chain these settings build. Raises ``KeyError``
    or ``ValueError`` for a tree of another chain."""
    out: Dict[str, Any] = {"mini_step": 0, "acc": None}
    node = raw
    if accum > 1:
        out["mini_step"] = int(node["mini_step"])
        out["acc"] = node["acc_grads"]
        node = node["inner_opt_state"]
    elif "mini_step" in node:
        raise ValueError("an accumulating chain's state for a chain "
                         "without accumulation")
    if set(node) != {"0", "1"}:
        raise ValueError(f"not the trainer's chain: keys {sorted(node)}")
    out["sched_count"] = int(node["1"]["count"])
    inner = node["0"]
    if patience:
        out["notfinite"] = int(inner["notfinite_count"])
        out["total_notfinite"] = int(inner["total_notfinite"])
        inner = inner["inner_state"]
    else:
        if "notfinite_count" in inner:
            raise ValueError("an apply_if_finite state for a chain "
                             "without it")
        out["notfinite"] = out["total_notfinite"] = 0
    core = inner["1"] if clip else inner["0"]
    if len(inner) != (2 if clip else 1) or \
            len(core) != (3 if kind == "adamw" else 2):
        raise ValueError("not the trainer's chain: clipping or the "
                         "optimizer's kind differ")
    adam = core["0"]
    out.update(count=int(adam["count"]), mu=adam["mu"], nu=adam["nu"])
    return out
