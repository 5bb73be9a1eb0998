"""Export the port's weights to a reference (SpeechBrain) checkpoint (port
of ``stac_st_tpu/interop/sb_export.py``).

The inverse of :mod:`.sb_import`: the port's modules (through
``interop.from_jax.to_jax_params``, :func:`export_modules`) or a params
tree in the JAX engine's layout becomes the flat ``model.ckpt`` state_dict
the reference's SB Checkpointer saves (``torch.nn.ModuleList([CNN, Transformer, seq_lin,
ctc_lin])`` — ``train_multitask.py:460-471``), so models trained in this
framework can be evaluated/served by the UNCHANGED reference tooling —
the reverse direction of the parity story. Round-trip identity
(export∘import == id and import∘export == id on the parameter set) is
asserted in ``tests/test_torch_sb_interop.py``.

Positional-encoding tables are buffers the reference recomputes
deterministically; they are NOT parameters and are omitted — load the
exported state_dict with ``strict=False`` or merge buffers from any
same-shape reference checkpoint (``extra`` argument).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from .from_jax import to_jax_params

__all__ = ["export_model_state_dict", "export_modules",
           "export_normalizer_dict"]


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _unwrap(tree: Mapping) -> Mapping:
    """Accept either {"params": …} module trees or bare param dicts."""
    return tree["params"] if "params" in tree else tree


def _linear(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[f"{key}.bias"] = _np(p["bias"])


def _layernorm(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _np(p["scale"])
    out[f"{key}.bias"] = _np(p["bias"])


def _mha(out: Dict, key: str, p: Mapping) -> None:
    qw = _np(p["q_proj"]["kernel"]).T  # (d, d) torch layout
    kw = _np(p["k_proj"]["kernel"]).T
    vw = _np(p["v_proj"]["kernel"]).T
    out[f"{key}.in_proj_weight"] = np.concatenate([qw, kw, vw], axis=0)
    out[f"{key}.in_proj_bias"] = np.concatenate([
        _np(p["q_proj"]["bias"]), _np(p["k_proj"]["bias"]),
        _np(p["v_proj"]["bias"]),
    ])
    _linear(out, f"{key}.out_proj", p["out_proj"])


def _export_cnn(out: Dict, cnn: Mapping, prefix: str = "0.") -> None:
    for name, p in cnn.items():
        if name.startswith("block") and "_conv" in name:
            b, l = name[5:].split("_conv")
            base = f"{prefix}convblock_{b}.convs.conv_{l}.conv"
            # flax (kT, kF, in, out) -> torch (out, in, kF, kT)
            out[f"{base}.weight"] = np.transpose(
                _np(p["kernel"]), (3, 2, 1, 0)
            )
            if "bias" in p:
                out[f"{base}.bias"] = _np(p["bias"])
        elif name.startswith("block") and "_norm" in name:
            b, l = name[5:].split("_norm")
            _layernorm(
                out, f"{prefix}convblock_{b}.convs.norm_{l}.norm", p
            )
        else:
            raise ValueError(f"unknown CNN param group {name!r}")


def _export_layer(out: Dict, base: str, layer: Mapping,
                  decoder: bool) -> None:
    _mha(out, f"{base}.{'self_attn' if decoder else 'self_att'}.att",
         layer["self_attn"])
    if decoder:
        # SB's historical spelling (mutihead_attn) — what real reference
        # checkpoints contain, and what sb_import accepts first
        _mha(out, f"{base}.mutihead_attn.att", layer["cross_attn"])
    _linear(out, f"{base}.pos_ffn.ffn.0", layer["ffn"]["fc1"])
    _linear(out, f"{base}.pos_ffn.ffn.3", layer["ffn"]["fc2"])
    _layernorm(out, f"{base}.norm1.norm", layer["norm1"])
    _layernorm(out, f"{base}.norm2.norm", layer["norm2"])
    if decoder:
        _layernorm(out, f"{base}.norm3.norm", layer["norm3"])


def _export_transformer(out: Dict, tr: Mapping, prefix: str = "1.") -> None:
    _linear(out, f"{prefix}custom_src_module.0.w", tr["src_proj"])
    out[f"{prefix}custom_tgt_module.0.emb.Embedding.weight"] = _np(
        tr["tgt_embed"]["embed"]["embedding"]
    )
    for side, dec in (("encoder", False), ("decoder", True)):
        stack = tr[side]
        i = 0
        while f"layer_{i}" in stack:
            _export_layer(
                out, f"{prefix}{side}.layers.{i}", stack[f"layer_{i}"], dec
            )
            i += 1
        _layernorm(out, f"{prefix}{side}.norm.norm", stack["final_norm"])


def export_model_state_dict(
    params: Mapping, extra: Optional[Mapping] = None,
) -> Dict[str, np.ndarray]:
    """Params tree → flat SB ``model.ckpt`` state_dict (numpy values).

    ``extra``: optional buffers (e.g. ``.pe`` tables from a reference
    checkpoint) merged into the output for strict-loading consumers.
    """
    out: Dict[str, np.ndarray] = {}
    _export_cnn(out, _unwrap(params["CNN"]))
    _export_transformer(out, _unwrap(params["Transformer"]))
    _linear(out, "2.w", _unwrap(params["seq_lin"])["linear"])
    if "ctc_lin" in params and params["ctc_lin"] is not None:
        _linear(out, "3.w", _unwrap(params["ctc_lin"])["linear"])
    for k, v in (extra or {}).items():
        out.setdefault(k, _np(v))
    return out


def export_modules(cnn, transformer, seq_lin, ctc_lin=None,
                   extra: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    """The port's modules → flat SB ``model.ckpt`` state_dict (numpy
    values, fp32)."""
    return export_model_state_dict(
        to_jax_params(cnn=cnn, transformer=transformer, seq_lin=seq_lin,
                      ctc_lin=ctc_lin), extra=extra)


def export_normalizer_dict(cmvn) -> Dict[str, Any]:
    """:class:`CmvnState` → SB ``InputNormalization`` statistics dict."""
    return {
        "glob_mean": _np(cmvn.mean),
        "glob_std": _np(cmvn.std),
        "count": float(_np(cmvn.count)),
    }
