"""Conformer encoder, ``encoder_module: conformer`` (port of
``stac_st_tpu/models/conformer.py``).

Layer structure (Gulati et al. 2020, SpeechBrain's ConformerEncoderLayer):

    x += ½·FFN(LN x);  x += MHA(LN x);  x += Conv(x);  x += ½·FFN(LN x);
    x = LN(x)

Both FFNs use the conformer activation (SiLU unless configured). The
stack has no final norm of its own: each layer ends in one. The decoder
stays a Transformer.

Conv module: LayerNorm → pointwise to 2·d → GLU → padded frames zeroed →
depthwise conv over time (kernel k, padding ((k−1)//2, k//2), or (k−1, 0)
when ``causal``) → LayerNorm → SiLU → pointwise to d → dropout. It keeps
the reference's LayerNorm where SpeechBrain has BatchNorm on purpose. The
depthwise conv is ``Conv1d(groups=d)``; its (d, 1, k) weight is the
reference's (k, 1, d) kernel transposed: both are cross-correlations, so
the taps are not flipped.

Attention is ``RelPosMHAXL`` (plain PyTorch) or the port's
``MultiHeadAttention``, whose key-padding attention runs through the
flash kernels in the teacher-forced forward (``mode``, as in
``models.transformer``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from .dropout import StepRandom, dropout
from .relpos import RelPosMultiHeadAttention
from .transformer import LN_EPS, FeedForward, MultiHeadAttention, remat_layer

__all__ = ["ConvModule", "ConformerEncoderLayer", "ConformerEncoder"]


class ConvModule(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 31,
                 dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.kernel_size, self.causal = int(kernel_size), bool(causal)
        self.dropout = float(dropout)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pw1 = nn.Linear(d_model, 2 * d_model)
        self.depthwise = nn.Conv1d(d_model, d_model, self.kernel_size,
                                   groups=d_model)
        self.conv_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pw2 = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None, train: bool = False,
                rng: Optional[StepRandom] = None) -> torch.Tensor:
        """x (B, T, d); pad_mask (B, T) bool, True where padded."""
        h = F.glu(self.pw1(self.norm(x)), dim=-1)
        if pad_mask is not None:
            h = h.masked_fill(pad_mask[..., None], 0.0)
        k = self.kernel_size
        pad = (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2)
        h = self.depthwise(F.pad(h.transpose(1, 2), pad)).transpose(1, 2)
        h = self.pw2(F.silu(self.conv_norm(h)))
        return dropout(h, self.dropout, rng) if train else h


class ConformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, d_ffn: int,
                 kernel_size: int = 31, dropout: float = 0.1,
                 activation: Callable = F.silu,
                 attention_type: str = "RelPosMHAXL", causal: bool = False):
        super().__init__()
        self.dropout = float(dropout)
        self.ffn1 = FeedForward(d_model, d_ffn, activation, dropout)
        self.ffn2 = FeedForward(d_model, d_ffn, activation, dropout)
        self.relpos = attention_type == "RelPosMHAXL"
        self.attn = (RelPosMultiHeadAttention if self.relpos
                     else MultiHeadAttention)(d_model, nhead, dropout)
        self.conv = ConvModule(d_model, kernel_size, dropout, causal)
        self.norm_ffn1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_ffn2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.final_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, bias=None, pad_mask=None,
                mode: Optional[str] = None, rng=None):
        train, p = mode == "train", self.dropout

        def drop(h):
            return dropout(h, p, rng) if train else h

        x = x + 0.5 * drop(self.ffn1(self.norm_ffn1(x), train, rng))
        h = self.norm_attn(x)
        h = (self.attn(h, bias, mode, rng) if self.relpos
             else self.attn(h, h, h, bias, mode, rng))
        x = x + drop(h)
        x = x + self.conv(x, pad_mask, train, rng)
        x = x + 0.5 * drop(self.ffn2(self.norm_ffn2(x), train, rng))
        return self.final_norm(x)


class ConformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int,
                 kernel_size: int = 31, dropout: float = 0.1,
                 activation: Callable = F.silu,
                 attention_type: str = "RelPosMHAXL", causal: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(d_model, nhead, d_ffn, kernel_size,
                                  dropout, activation, attention_type, causal)
            for _ in range(num_layers))

    def forward(self, x, bias=None, pad_mask=None,
                mode: Optional[str] = None, rng=None):
        """``remat`` recomputes each layer in the backward of a training
        forward (see ``models.transformer.remat_layer``)."""
        for layer in self.layers:
            if self.remat and mode == "train":
                x = remat_layer(layer, x, (bias, pad_mask, mode), rng)
            else:
                x = layer(x, bias, pad_mask, mode, rng)
        return x
