"""Transformer-XL relative-position attention, ``RelPosMHAXL`` (port of
``stac_st_tpu/models/relpos.py``).

Scores follow Transformer-XL (Dai et al. 2019):

    A = ((q + u)·kᵀ + rel_shift((q + v)·pᵀ)) · scale + bias

with learned content and position biases u, v of shape (H, Dh) and the
sinusoidal embeddings p of the relative distances L-1 … -(L-1), projected
by ``pos_proj`` (no bias). The shift is the pad-reshape trick of the
reference. Both score products accumulate in fp32, as the reference's
``preferred_element_type``; the position projection runs in fp32 (the
reference's fp32 table promotes it). Dropout hits the softmax weights in
training, drawn from the step's :class:`~.dropout.StepRandom`.

This attention is plain PyTorch: the reference computes it with XLA
einsums, not a Pallas kernel. As in the port's ``MultiHeadAttention``,
q, k and v come from one ``in_proj`` whose (3·d, d) weight stacks the
reference's ``q_proj``, ``k_proj`` and ``v_proj``. The decoder never
takes it: relative positions apply to the encoder only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .dropout import StepRandom, dropout

__all__ = ["RelPosMultiHeadAttention", "relative_sinusoidal_table",
           "rel_shift"]


def relative_sinusoidal_table(seq_len: int, d_model: int) -> np.ndarray:
    """(2·seq_len − 1, d_model) float32 embeddings of the distances
    seq_len − 1 … −(seq_len − 1), computed in float64."""
    pos = np.arange(seq_len - 1, -seq_len, -1, dtype=np.float64)[:, None]
    i = np.arange(0, d_model, 2, dtype=np.float64)[None, :]
    denom = np.power(10000.0, i / d_model)
    table = np.zeros((pos.shape[0], d_model), np.float64)
    table[:, 0::2] = np.sin(pos / denom)
    table[:, 1::2] = np.cos(pos / denom[:, : table[:, 1::2].shape[1]])
    return table.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _table(seq_len: int, d_model: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(relative_sinusoidal_table(seq_len, d_model)).to(
        device)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T − 1) -> (B, H, T, T): row i keeps the scores of the
    distances i − j for j = 0 … T − 1."""
    B, H, T, L = x.shape
    x = F.pad(x, (1, 0)).reshape(B, H, L + 1, T)
    return x[:, :, 1:, :].reshape(B, H, T, L)[..., :T]


class RelPosMultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} not divisible by {nhead}")
        self.d_model, self.nhead = d_model, nhead
        self.head_dim = d_model // nhead
        self.dropout = float(dropout)
        self.scale = 1.0 / math.sqrt(self.head_dim)
        self.in_proj = nn.Linear(d_model, 3 * d_model)  # rows: q | k | v
        self.pos_proj = nn.Linear(d_model, d_model, bias=False)
        self.out_proj = nn.Linear(d_model, d_model)
        self.u_bias = nn.Parameter(torch.zeros(nhead, self.head_dim))
        self.v_bias = nn.Parameter(torch.zeros(nhead, self.head_dim))

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                mode: Optional[str] = None,
                rng: Optional[StepRandom] = None) -> torch.Tensor:
        """Self-attention of x (B, T, d); bias additive fp32, broadcastable
        to (B, H, T, T). Dropout on the weights when ``mode == "train"``."""
        B, T, _ = x.shape
        H, Dh = self.nhead, self.head_dim
        q, k, v = self.in_proj(x).reshape(B, T, 3, H, Dh).transpose(
            1, 3).unbind(2)  # each (B, H, T, Dh)
        table = _table(T, self.d_model, x.device)
        p = F.linear(table, self.pos_proj.weight.float())
        p = p.reshape(2 * T - 1, H, Dh).permute(1, 2, 0)  # (H, Dh, 2T-1)
        qu = (q + self.u_bias[None, :, None, :]).float()
        qv = (q + self.v_bias[None, :, None, :]).float()
        content = torch.matmul(qu, k.float().transpose(-1, -2))
        position = torch.matmul(qv, p[None])
        logits = (content + rel_shift(position)) * self.scale
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(x.dtype)
        if mode == "train":
            weights = dropout(weights, self.dropout, rng)
        out = torch.matmul(weights.float(), v.float()).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, self.d_model))
