"""Pre-LN Transformer encoder/decoder with KV-cached decoding.

Port of the inference parts of ``stac_st_tpu/models/transformer.py``.
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

Unlike the functional JAX cache, the port appends to its caches in place
(one row write per step, no copy) and keeps the write index as a host int.
Encoder self-attention stays plain ``matmul`` + softmax, as in the
reference's inference path.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kernels.decode_attention import (
    decode_cross_attention,
    decode_self_attention,
    decode_self_attention_anc,
)
from .activations import default_activation

__all__ = [
    "NormalizedEmbedding", "MultiHeadAttention", "FeedForward",
    "EncoderLayer", "DecoderLayer", "TransformerEncoder",
    "TransformerDecoder",
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
    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead}")
        self.d_model, self.nhead = d_model, nhead
        self.head_dim = d_model // nhead
        self.scale = 1.0 / math.sqrt(self.head_dim)
        self.in_proj = nn.Linear(d_model, 3 * d_model)  # rows: q | k | v
        self.out_proj = nn.Linear(d_model, d_model)

    def _proj(self, x: torch.Tensor, part: int) -> torch.Tensor:
        d = self.d_model
        sl = slice(part * d, (part + 1) * d)
        return F.linear(x, self.in_proj.weight[sl], self.in_proj.bias[sl])

    # ---- full-sequence attention (encoder, oracle decode) -----------------
    def forward(self, query, key, value, bias=None):
        """query (B, Tq, d), key/value (B, Tk, d); bias broadcastable to
        (B, H, Tq, Tk), additive fp32."""
        B, Tq, _ = query.shape
        Tk = key.shape[1]
        H, Dh = self.nhead, self.head_dim
        q = self._proj(query, 0).reshape(B, Tq, H, Dh).transpose(1, 2)
        k = self._proj(key, 1).reshape(B, Tk, H, Dh).transpose(1, 2)
        v = self._proj(value, 2).reshape(B, Tk, H, Dh).transpose(1, 2)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits * self.scale
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
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
        (in place) and attends positions 0..index."""
        q, k_new, v_new = self.fused_qkv(x)
        idx = cache["index"]
        cache["k"][:, :, :, idx] = k_new
        cache["v"][:, :, idx, :] = v_new
        attn = decode_self_attention(self._scaled(q), cache["k"], cache["v"],
                                     idx)
        cache["index"] = idx + 1
        return self.out_proj(attn.reshape(x.shape[0], self.d_model))

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
                   bias: Optional[torch.Tensor], beam: int) -> torch.Tensor:
        """x (B·beam, d) against per-utterance Kᵀ/V; bias (B, S) or None."""
        BB = x.shape[0]
        q = self._proj(x, 0).reshape(BB, self.nhead, self.head_dim)
        attn = decode_cross_attention(self._scaled(q), kT, v, bias, beam)
        return self.out_proj(attn.reshape(BB, self.d_model))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ffn: int,
                 activation: Callable = default_activation):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ffn)
        self.fc2 = nn.Linear(d_ffn, d_model)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.activation(self.fc1(x)))


class EncoderLayer(nn.Module):
    """Pre-LN encoder layer."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FeedForward(d_model, d_ffn, activation)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, bias=None):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, bias)
        return x + self.ffn(self.norm2(x))


class DecoderLayer(nn.Module):
    """Pre-LN decoder layer: self-attention, cross-attention, FFN."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation):
        super().__init__()
        self.nhead, self.head_dim = nhead, d_model // nhead
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.cross_attn = MultiHeadAttention(d_model, nhead)
        self.ffn = FeedForward(d_model, d_ffn, activation)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, memory, self_bias=None, cross_bias=None):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, self_bias)
        h = self.norm2(x)
        x = x + self.cross_attn(h, memory, memory, cross_bias)
        return x + self.ffn(self.norm3(x))

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor,
                   anc_mode: bool) -> Dict[str, Any]:
        """Self caches for ``batch`` (= B·beam) rows, cross K/V once per
        utterance of ``memory`` (B, S, d)."""
        k_cross, v_cross = self.cross_attn.project_kv_decode(memory)
        H, Dh = self.nhead, self.head_dim
        k_shape = ((batch, H, max_len, Dh) if anc_mode
                   else (batch, H, Dh, max_len))
        zeros = dict(dtype=memory.dtype, device=memory.device)
        return {
            "self": {"k": torch.zeros(k_shape, **zeros),
                     "v": torch.zeros((batch, H, max_len, Dh), **zeros),
                     "index": 0},
            "cross_k": k_cross,
            "cross_v": v_cross,
        }

    def step(self, x, cache, cross_bias=None, beam: int = 1, anc=None):
        h = self.norm1(x)
        if anc is not None:
            h = self.self_attn.step_anc(h, cache["self"], anc, beam)
        else:
            h = self.self_attn.step(h, cache["self"])
        x = x + h
        x = x + self.cross_attn.step_cross(
            self.norm2(x), cache["cross_k"], cache["cross_v"], cross_bias,
            beam)
        return x + self.ffn(self.norm3(x))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, d_ffn, activation)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, bias=None):
        for layer in self.layers:
            x = layer(x, bias)
        return self.final_norm(x)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 activation: Callable = default_activation):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, d_ffn, activation)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, memory, self_bias=None, cross_bias=None):
        for layer in self.layers:
            x = layer(x, memory, self_bias, cross_bias)
        return self.final_norm(x)

    def init_cache(self, batch: int, max_len: int, memory,
                   anc_mode: bool) -> List[Dict[str, Any]]:
        return [layer.init_cache(batch, max_len, memory, anc_mode)
                for layer in self.layers]

    def step(self, x, caches, cross_bias=None, beam: int = 1, anc=None):
        for layer, cache in zip(self.layers, caches):
            x = layer.step(x, cache, cross_bias, beam, anc)
        return self.final_norm(x)
