"""Transformer encoder/decoder with KV-cached decoding.

Port of ``stac_st_tpu/models/transformer.py``. Layers are pre-LN
(``normalize_before=True``: ``x + f(LN x)``) or post-LN (``LN(x + f(x))``),
in every path of the decoder (the full sequence, each decode step form,
the window); both stacks end in their ``final_norm`` either way. An
encoder layer's self-attention is regular or ``RelPosMHAXL``
(``models.relpos``). ``remat`` recomputes each encoder layer in the
backward of a training forward (:func:`remat_layer`).
Parameter layout follows PyTorch: each attention block holds one
``in_proj`` Linear whose (3·d, d) weight stacks the q, k and v projections
in the order of the reference's ``_fused_qkv``.

Decode mode keeps the reference's cache layouts:

* beam 1: Kᵀ (BB, H, Dh, S) and V (BB, H, S, Dh), attended by
  ``decode_self_attention``;
* beam > 1 (anc mode): K and V both (BB, H, S, Dh), never reordered;
  hypothesis r reads position s from the row the ancestor table names
  (``decode_self_attention_anc``);
* cross-attention K/V are projected once per utterance (B rows, untiled)
  and shared by the beam queries (``decode_cross_attention``).

With ``cache_dtype='int8'`` (beam-1 layout only) the self Kᵀ and V are
int8 with one fp32 scale per (row, head, position), ``k_scale`` and
``v_scale`` (BB, H, 1, S): each new row is quantized over Dh when it is
appended (max|x|/127, at least 1e-6/127); the cross K/V are quantized
once per utterance the same way (``cross_k_scale``, ``cross_v_scale``
(B, H, 1, S)). The unscaled query goes to ``decode_self_attention_int8``
/ ``decode_cross_attention_int8``, where K's scale rides the logits and
V's the softmax weights (the reference's ``_step_int8`` and
``_step_cross_int8``). An unwritten position has scale 0 and is masked.
Modules quantized by ``utils.quantize`` (int8 weights) serve this decode
path only; the full-sequence ``forward`` raises on them.

Unlike the functional JAX cache, the port appends to its caches in place
(one row write per step, no copy) and keeps the write index as a host int.
Continuous batching keeps it as a (BB,) int32 device tensor instead, one
index per slot (the ragged step): each row appends at its own index, an
index past the cache writes nothing, and the self kernel reads each row's
positions up to its index. ``step_window`` primes w positions at once
(causal (w, S) attention in plain ``matmul`` + softmax, as the reference
computes it in XLA; cross-attention through the kernel with the window as
the beam).

Full-sequence attention takes a ``mode``:

* ``None`` (``encode`` and the oracle ``decode``, the serving paths):
  plain ``matmul`` + softmax, as the reference's inference path;
* ``"eval"`` (the teacher-forced forward with training off): a
  key-padding-only bias (encoder self-attention, decoder
  cross-attention) goes to the ``flash_attention`` kernel;
* ``"train"``: a key-padding-only bias goes to ``flash_attention_train``
  with its in-kernel dropout, one 32-bit seed drawn per call (the
  reference's ``_flash_trainable`` route, transformer.py:125-158); any
  other bias (decoder self-attention with its causal mask) takes matmul +
  softmax + dropout on the weights. Dropout also hits the FFN hidden
  layer and the residual branches, as in the reference.

With ``use_kernel`` False (``TransformerMultiTask.use_attention_kernels``,
the run option ``train_attn_kernel=off``) ``"train"`` and ``"eval"`` send
every bias down the matmul + softmax path, dropout on the weights in
training: the reference's XLA ``_attend`` route.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.attention import flash_attention
from ..ops.kernels.decode_attention import (
    decode_cross_attention,
    decode_cross_attention_int8,
    decode_self_attention,
    decode_self_attention_anc,
    decode_self_attention_int8,
)
from ..ops.kernels.train_attention import flash_attention_train
from ..ops.masks import NEG_INF
from .activations import default_activation
from .dropout import StepRandom, dropout
from .relpos import RelPosMultiHeadAttention

__all__ = [
    "NormalizedEmbedding", "MultiHeadAttention", "FeedForward",
    "EncoderLayer", "DecoderLayer", "TransformerEncoder",
    "TransformerDecoder", "remat_layer",
]

LN_EPS = 1e-6  # flax nn.LayerNorm default


class NormalizedEmbedding(nn.Module):
    """Embedding scaled by sqrt(d_model) (SpeechBrain NormalizedEmbedding)."""

    def __init__(self, d_model: int, vocab: int):
        super().__init__()
        self.d_model = d_model
        self.embed = nn.Embedding(vocab, d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens) * math.sqrt(self.d_model)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead}")
        self.d_model, self.nhead = d_model, nhead
        self.dropout = float(dropout)
        self.head_dim = d_model // nhead
        self.scale = 1.0 / math.sqrt(self.head_dim)
        self.in_proj = nn.Linear(d_model, 3 * d_model)  # rows: q | k | v
        self.out_proj = nn.Linear(d_model, d_model)
        # False: "train" and "eval" modes take the plain path too (run
        # option train_attn_kernel=off)
        self.use_kernel = True

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        if not isinstance(self.in_proj, nn.Linear):  # int8 cross in_proj
            return self.in_proj.part(x, part)
        d = self.d_model
        sl = slice(part * d, (part + 1) * d)
        return F.linear(x, self.in_proj.weight[sl], self.in_proj.bias[sl])

    # ---- full-sequence attention ------------------------------------------
    def forward(self, query, key, value, bias=None, mode: Optional[str] = None,
                rng: Optional[StepRandom] = None):
        """query (B, Tq, d), key/value (B, Tk, d); bias broadcastable to
        (B, H, Tq, Tk), additive fp32. ``mode`` as in the module note."""
        if not (isinstance(self.in_proj, nn.Linear)
                and isinstance(self.out_proj, nn.Linear)):
            raise RuntimeError("int8-quantized attention serves the "
                               "KV-cached decode path only")
        B, Tq, _ = query.shape
        Tk = key.shape[1]
        H, Dh = self.nhead, self.head_dim
        q = self._proj(query, 0).reshape(B, Tq, H, Dh)
        k = self._proj(key, 1).reshape(B, Tk, H, Dh)
        v = self._proj(value, 2).reshape(B, Tk, H, Dh)
        key_pad_only = bias is None or (
            bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)
        if mode is not None and key_pad_only and self.use_kernel:
            bias2 = None if bias is None else bias.reshape(B, Tk).contiguous()
            if mode == "train":
                p = self.dropout
                seed = rng.kernel_seed() if p > 0.0 else 0
                out = flash_attention_train(q, k, v, bias2, seed, p,
                                            rng.row0 if rng else 0)
            else:
                out = flash_attention(q, k, v, bias2)
            return self.out_proj(out.reshape(B, Tq, self.d_model))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits * self.scale
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        if mode == "train":
            weights = dropout(weights, self.dropout, rng)
        out = torch.matmul(weights.float(), v.float()).to(q.dtype)
        out = out.transpose(1, 2).reshape(B, Tq, self.d_model)
        return self.out_proj(out)

    # ---- decode mode ------------------------------------------------------
    def _scaled(self, q: torch.Tensor) -> torch.Tensor:
        return (q.float() * self.scale).to(q.dtype)

    def fused_qkv(self, x: torch.Tensor):
        """x (BB, d) -> q, k, v each (BB, H, Dh): one (d, 3d) matmul."""
        BB = x.shape[0]
        q, k, v = self.in_proj(x).split(self.d_model, dim=-1)
        shape = (BB, self.nhead, self.head_dim)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def project_kv_decode(self, memory: torch.Tensor):
        """Cross K/V in decode layouts: Kᵀ (B, H, Dh, S), V (B, H, S, Dh)."""
        B, S, _ = memory.shape
        k = self._proj(memory, 1).reshape(B, S, self.nhead, self.head_dim)
        v = self._proj(memory, 2).reshape(B, S, self.nhead, self.head_dim)
        return (k.permute(0, 2, 3, 1).contiguous(),
                v.transpose(1, 2).contiguous())

    def step(self, x: torch.Tensor, cache: Dict[str, Any]) -> torch.Tensor:
        """Beam-1 layout step: appends this step's K/V at ``cache["index"]``
        (in place) and attends positions 0..index. A tensor index (BB,) is
        the ragged step: row r appends at index[r] (nothing where
        index[r] >= S) and attends its positions 0..min(index[r], S - 1).
        An int8 cache quantizes the new row first and appends its scales
        too."""
        q, k_new, v_new = self.fused_qkv(x)
        idx = cache["index"]
        if cache["k"].dtype == torch.int8:
            k_new, s_k = quantize_rows(k_new, -1)  # scale (BB, H, 1)
            v_new, s_v = quantize_rows(v_new, -1)
            _append(cache["k_scale"], s_k, idx, 3)
            _append(cache["v_scale"], s_v, idx, 3)
        _append(cache["k"], k_new, idx, 3)
        _append(cache["v"], v_new, idx, 2)
        if cache["k"].dtype == torch.int8:
            attn = decode_self_attention_int8(
                q.contiguous(), cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], idx)
        else:
            attn = decode_self_attention(self._scaled(q), cache["k"],
                                         cache["v"], idx)
        cache["index"] = idx + 1
        return self.out_proj(attn.reshape(x.shape[0], self.d_model))

    def step_window(self, x: torch.Tensor, cache: Dict[str, Any]
                    ) -> torch.Tensor:
        """Windowed step, x (B, w, d) at positions index..index+w-1 (a
        host int index): appends the w K/V rows (quantized, with their
        scales, into an int8 cache), attends causally (key j is visible to
        window row r iff j <= index + r) and advances the index by w.
        Equal to w ``step`` calls."""
        B, w, _ = x.shape
        H, Dh = self.nhead, self.head_dim
        q, k_new, v_new = self.fused_qkv(x.reshape(B * w, self.d_model))
        q, k_new, v_new = (t.reshape(B, w, H, Dh).transpose(1, 2)
                           for t in (q, k_new, v_new))  # (B, H, w, Dh)
        idx = cache["index"]
        S = cache["k"].shape[-1]
        int8 = cache["k"].dtype == torch.int8
        if int8:
            k_new, s_k = quantize_rows(k_new, -1)  # (B,H,w,Dh), (B,H,w,1)
            v_new, s_v = quantize_rows(v_new, -1)
            cache["k_scale"][:, :, :, idx:idx + w] = s_k.transpose(-1, -2)
            cache["v_scale"][:, :, :, idx:idx + w] = s_v.transpose(-1, -2)
        cache["k"][:, :, :, idx:idx + w] = k_new.transpose(-1, -2)
        cache["v"][:, :, idx:idx + w, :] = v_new
        pos = torch.arange(S, device=x.device)
        rows = idx + torch.arange(w, device=x.device)
        bias = torch.where(pos[None, :] > rows[:, None], NEG_INF, 0.0)
        logits = torch.matmul(q.float(), cache["k"].float())
        if int8:  # K's scale rides the logits, V's the softmax weights
            logits = logits * (cache["k_scale"] * self.scale)
            weights = torch.softmax(logits + bias, dim=-1)
            weights = (weights * cache["v_scale"]).to(q.dtype)
        else:
            weights = torch.softmax(logits * self.scale + bias,
                                    dim=-1).to(q.dtype)
        out = torch.matmul(weights.float(), cache["v"].float()).to(q.dtype)
        cache["index"] = idx + w
        return self.out_proj(out.transpose(1, 2).reshape(B, w, self.d_model))

    def step_anc(self, x: torch.Tensor, cache: Dict[str, Any],
                 anc: torch.Tensor, beam: int) -> torch.Tensor:
        """Anc-mode step: K/V rows stay where they were written; ``anc``
        (B, beam, S) names each hypothesis's row per position."""
        q, k_new, v_new = self.fused_qkv(x)
        idx = cache["index"]
        cache["k"][:, :, idx, :] = k_new
        cache["v"][:, :, idx, :] = v_new
        attn = decode_self_attention_anc(self._scaled(q), cache["k"],
                                         cache["v"], anc, idx, beam)
        cache["index"] = idx + 1
        return self.out_proj(attn.reshape(x.shape[0], self.d_model))

    def step_cross(self, x: torch.Tensor, kT: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], beam: int,
                   scales=None) -> torch.Tensor:
        """x (B·beam, d) against per-utterance Kᵀ/V; bias (B, S) or None;
        ``scales`` (k_scale, v_scale), each (B, H, 1, S), for int8 K/V."""
        BB = x.shape[0]
        q = self._proj(x, 0).reshape(BB, self.nhead, self.head_dim)
        if scales is not None:
            attn = decode_cross_attention_int8(q, kT, v, *scales, bias, beam)
        else:
            attn = decode_cross_attention(self._scaled(q), kT, v, bias, beam)
        return self.out_proj(attn.reshape(BB, self.d_model))


def quantize_rows(x: torch.Tensor, dim: int):
    """x as int8 with one fp32 scale over ``dim`` (kept, size 1):
    max|x|/127, at least 1e-6/127, the value in its own dtype cast to
    fp32, divided by the scale, rounded half to even and clipped to
    ±127. Returns (values, scale)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-6) / 127.0
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _append(t: torch.Tensor, new: torch.Tensor, idx, axis: int) -> None:
    """Write new (BB, H, X) into t (BB, H, ·, ·) at position ``idx`` of
    ``axis`` (3: Kᵀ-like, 2: V-like), in place. A tensor ``idx`` (BB,) is
    one position per row: rows whose index is past S keep their cache
    (the reference's where-append writes nothing there), with one gather
    and one scatter of BB rows and no host read."""
    if not isinstance(idx, torch.Tensor):
        t.select(axis, idx).copy_(new)
        return
    S = t.shape[axis]
    pos = idx.clamp(max=S - 1).long()
    rows = torch.arange(t.shape[0], device=t.device)
    keep = (idx >= S)[:, None, None]
    if axis == 3:
        t[rows, :, :, pos] = torch.where(keep, t[rows, :, :, pos], new)
    else:
        t[rows, :, pos, :] = torch.where(keep, t[rows, :, pos, :], new)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ffn: int,
                 activation: Callable = default_activation,
                 dropout: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ffn)
        self.fc2 = nn.Linear(d_ffn, d_model)
        self.activation = activation
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[StepRandom] = None) -> torch.Tensor:
        h = self.activation(self.fc1(x))
        if train:
            h = dropout(h, self.dropout, rng)
        return self.fc2(h)


def _residual(x, h, p: float, mode: Optional[str], rng):
    return x + (dropout(h, p, rng) if mode == "train" else h)


def remat_layer(layer: nn.Module, x: torch.Tensor, args: tuple,
                rng: Optional[StepRandom]) -> torch.Tensor:
    """``layer(x, *args, rng)`` whose activations are recomputed in the
    backward instead of kept (``torch.utils.checkpoint``, non-reentrant).

    The recompute replays the forward exactly: it runs on the parameter
    tensors the forward read (under ``functional_call`` those are the
    step's views, not the module's own), and it restores the
    :class:`StepRandom` state the forward started from, so its dropout
    masks and kernel seeds are the same draws; the generators are put
    back afterwards."""
    params = dict(layer.named_parameters())
    start = rng.get_state() if rng is not None else None
    calls = []

    def run(x):
        if not calls:  # the forward
            calls.append(1)
            return layer(x, *args, rng)
        after = rng.get_state() if rng is not None else None
        if rng is not None:
            rng.set_state(start)
        try:
            return torch.func.functional_call(layer, params,
                                              (x, *args, rng))
        finally:
            if rng is not None:
                rng.set_state(after)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class EncoderLayer(nn.Module):
    """Encoder layer: self-attention (regular or ``RelPosMHAXL``) and FFN,
    pre-LN or post-LN."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation,
                 dropout: float = 0.0, normalize_before: bool = True,
                 attention_type: str = "regularMHA"):
        super().__init__()
        self.dropout = float(dropout)
        self.normalize_before = bool(normalize_before)
        self.relpos = attention_type == "RelPosMHAXL"
        self.self_attn = (RelPosMultiHeadAttention if self.relpos
                          else MultiHeadAttention)(d_model, nhead, dropout)
        self.ffn = FeedForward(d_model, d_ffn, activation, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def _attend(self, h, bias, mode, rng):
        if self.relpos:
            return self.self_attn(h, bias, mode, rng)
        return self.self_attn(h, h, h, bias, mode, rng)

    def forward(self, x, bias=None, mode: Optional[str] = None, rng=None):
        p, train = self.dropout, mode == "train"
        if self.normalize_before:
            x = _residual(x, self._attend(self.norm1(x), bias, mode, rng), p,
                          mode, rng)
            h = self.ffn(self.norm2(x), train, rng)
            return _residual(x, h, p, mode, rng)
        x = self.norm1(_residual(x, self._attend(x, bias, mode, rng), p, mode,
                                 rng))
        return self.norm2(_residual(x, self.ffn(x, train, rng), p, mode, rng))


class DecoderLayer(nn.Module):
    """Decoder layer: self-attention, cross-attention, FFN; pre-LN or
    post-LN."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation,
                 dropout: float = 0.0, normalize_before: bool = True):
        super().__init__()
        self.nhead, self.head_dim = nhead, d_model // nhead
        self.dropout = float(dropout)
        self.normalize_before = bool(normalize_before)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.ffn = FeedForward(d_model, d_ffn, activation, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, memory, self_bias=None, cross_bias=None,
                mode: Optional[str] = None, rng=None):
        p, train = self.dropout, mode == "train"
        if self.normalize_before:
            h = self.norm1(x)
            x = _residual(x, self.self_attn(h, h, h, self_bias, mode, rng),
                          p, mode, rng)
            h = self.norm2(x)
            x = _residual(x, self.cross_attn(h, memory, memory, cross_bias,
                                             mode, rng), p, mode, rng)
            h = self.ffn(self.norm3(x), train, rng)
            return _residual(x, h, p, mode, rng)
        x = self.norm1(_residual(x, self.self_attn(x, x, x, self_bias, mode,
                                                   rng), p, mode, rng))
        x = self.norm2(_residual(x, self.cross_attn(x, memory, memory,
                                                    cross_bias, mode, rng),
                                 p, mode, rng))
        return self.norm3(_residual(x, self.ffn(x, train, rng), p, mode, rng))

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor,
                   anc_mode: bool, cache_dtype: Optional[str] = None
                   ) -> Dict[str, Any]:
        """Self caches for ``batch`` (= B·beam) rows, cross K/V once per
        utterance of ``memory`` (B, S, d). ``cache_dtype='int8'``: the
        int8 caches and their scales (beam-1 layout only)."""
        k_cross, v_cross = self.cross_attn.project_kv_decode(memory)
        H, Dh = self.nhead, self.head_dim
        k_shape = ((batch, H, max_len, Dh) if anc_mode
                   else (batch, H, Dh, max_len))
        dtype = memory.dtype
        if cache_dtype == "int8":
            if anc_mode:
                raise ValueError("the int8 cache has no anc-mode layout")
            dtype = torch.int8
        zeros = dict(dtype=dtype, device=memory.device)
        cache = {
            "self": {"k": torch.zeros(k_shape, **zeros),
                     "v": torch.zeros((batch, H, max_len, Dh), **zeros),
                     "index": 0},
            "cross_k": k_cross,
            "cross_v": v_cross,
        }
        if cache_dtype == "int8":
            scale = dict(dtype=torch.float32, device=memory.device)
            cache["self"]["k_scale"] = torch.zeros((batch, H, 1, max_len),
                                                   **scale)
            cache["self"]["v_scale"] = torch.zeros((batch, H, 1, max_len),
                                                   **scale)
            # read every step: quantized once per utterance, one scale per
            # (utterance, head, position) over Dh
            cache["cross_k"], cache["cross_k_scale"] = quantize_rows(
                k_cross, 2)  # (B, H, Dh, S), (B, H, 1, S)
            cache["cross_v"], s_v = quantize_rows(v_cross, 3)
            cache["cross_v_scale"] = s_v.transpose(2, 3).contiguous()
        return cache

    @staticmethod
    def _cross_scales(cache):
        if "cross_k_scale" not in cache:
            return None
        return cache["cross_k_scale"], cache["cross_v_scale"]

    def step(self, x, cache, cross_bias=None, beam: int = 1, anc=None):
        nb = self.normalize_before
        h = self.norm1(x) if nb else x
        if anc is not None:
            h = self.self_attn.step_anc(h, cache["self"], anc, beam)
        else:
            h = self.self_attn.step(h, cache["self"])
        scales = self._cross_scales(cache)
        if nb:
            x = x + h
            x = x + self.cross_attn.step_cross(
                self.norm2(x), cache["cross_k"], cache["cross_v"],
                cross_bias, beam, scales)
            return x + self.ffn(self.norm3(x))
        x = self.norm1(x + h)
        x = self.norm2(x + self.cross_attn.step_cross(
            x, cache["cross_k"], cache["cross_v"], cross_bias, beam, scales))
        return self.norm3(x + self.ffn(x))

    def step_window(self, x, cache, cross_bias=None):
        """Windowed step, x (B, w, d): self-attention through
        ``MultiHeadAttention.step_window``, cross-attention with the window
        as the beam (each utterance's encoder K/V read once)."""
        B, w, d = x.shape
        nb = self.normalize_before
        h = self.self_attn.step_window(self.norm1(x) if nb else x,
                                       cache["self"])
        x = x + h if nb else self.norm1(x + h)
        q = (self.norm2(x) if nb else x).reshape(B * w, d)
        h = self.cross_attn.step_cross(
            q, cache["cross_k"], cache["cross_v"], cross_bias, w,
            self._cross_scales(cache)).reshape(B, w, d)
        if nb:
            x = x + h
            return x + self.ffn(self.norm3(x))
        x = self.norm2(x + h)
        return self.norm3(x + self.ffn(x))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation,
                 dropout: float = 0.0, normalize_before: bool = True,
                 attention_type: str = "regularMHA", remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, d_ffn, activation, dropout,
                         normalize_before, attention_type)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, bias=None, mode: Optional[str] = None, rng=None):
        for layer in self.layers:
            if self.remat and mode == "train":
                x = remat_layer(layer, x, (bias, mode), rng)
            else:
                x = layer(x, bias, mode, rng)
        return self.final_norm(x)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation,
                 dropout: float = 0.0, normalize_before: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, d_ffn, activation, dropout,
                         normalize_before)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, memory, self_bias=None, cross_bias=None,
                mode: Optional[str] = None, rng=None):
        for layer in self.layers:
            x = layer(x, memory, self_bias, cross_bias, mode, rng)
        return self.final_norm(x)

    def init_cache(self, batch: int, max_len: int, memory,
                   anc_mode: bool, cache_dtype: Optional[str] = None
                   ) -> List[Dict[str, Any]]:
        return [layer.init_cache(batch, max_len, memory, anc_mode,
                                 cache_dtype)
                for layer in self.layers]

    def step(self, x, caches, cross_bias=None, beam: int = 1, anc=None):
        for layer, cache in zip(self.layers, caches):
            x = layer.step(x, cache, cross_bias, beam, anc)
        return self.final_norm(x)

    def step_window(self, x, caches, cross_bias=None):
        for layer, cache in zip(self.layers, caches):
            x = layer.step_window(x, cache, cross_bias)
        return self.final_norm(x)
