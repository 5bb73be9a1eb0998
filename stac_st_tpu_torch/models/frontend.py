"""Convolutional front end (port of ``stac_st_tpu/models/frontend.py``).

Blocks of Conv2d (symmetric ``k//2`` padding) -> LayerNorm ->
LeakyReLU(0.01) -> Dropout over (time, freq). The reference's
configuration is two blocks of one layer each, kernel 3, stride 2, no
residuals: 100 Hz fbank frames become 25 Hz encoder frames and 80 mels
become 20. A block may hold ``num_layers_per_block`` layers, of which the
last takes the block's stride (the others stride 1), and ``residuals[b]``
adds each layer's input of block b to its output where their shapes
match. ``num_blocks`` (at most ``len(out_channels)``) takes the first
entries of ``out_channels``, ``kernel_sizes`` and ``strides``. Dropout is
active only when the caller passes ``train=True`` with a
:class:`~stac_st_tpu_torch.models.dropout.StepRandom`.

The constructor also takes the YAML's ``input_shape``, whose last entry is
``n_mels`` (the port sizes its LayerNorms when it is built, so it must
know the mel count; the JAX module reads it from the features).

The JAX module is NHWC with H = time and W = freq. Activations stay in that
layout here and are permuted to NCHW only around each convolution, so the
LayerNorm reduces over (freq, channel) jointly with (F, C)-shaped scale and
bias (eps 1e-5), and the output (B, T', F', C) flattens to F'·C features in
the same order as the reference's ``_flatten_src``. Layer l of block b is
``block{b}_conv{l}`` and ``block{b}_norm{l}``, the reference's names.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .dropout import StepRandom, dropout
from .settings import require

__all__ = ["ConvolutionFrontEnd", "conv_out_length"]


def conv_out_length(length: int, num_blocks: int = 2, stride: int = 2) -> int:
    for _ in range(num_blocks):
        length = -(-length // stride)
    return length


class ConvolutionFrontEnd(nn.Module):
    def __init__(self, n_mels: Optional[int] = None,
                 out_channels: Sequence[int] = (256, 256),
                 kernel_sizes: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (2, 2), dropout: float = 0.1,
                 input_shape: Optional[Sequence[int]] = None,
                 num_blocks: Optional[int] = None,
                 num_layers_per_block: int = 1,
                 residuals: Optional[Sequence[bool]] = None):
        super().__init__()
        owner = "ConvolutionFrontEnd"
        if input_shape is not None:
            if n_mels is not None:
                require(owner, "input_shape[-1]", int(input_shape[-1]),
                        int(n_mels))
            n_mels = int(input_shape[-1])
        n_mels = 80 if n_mels is None else int(n_mels)
        n_max = min(len(out_channels), len(kernel_sizes), len(strides))
        self.num_blocks = n_max if num_blocks is None else int(num_blocks)
        if self.num_blocks > n_max:
            raise ValueError(
                f"{owner} num_blocks={self.num_blocks}: more blocks than "
                f"out_channels/kernel_sizes/strides entries ({n_max})")
        self.num_layers_per_block = int(num_layers_per_block)
        residuals = tuple(bool(r) for r in (residuals or ()))
        self.residuals = residuals + (False,) * (self.num_blocks
                                                 - len(residuals))
        self.dropout = float(dropout)
        self.layers = nn.ModuleDict()
        freq, c_in = n_mels, 1
        for b in range(self.num_blocks):
            c_out, k = int(out_channels[b]), int(kernel_sizes[b])
            for l in range(self.num_layers_per_block):
                s = (int(strides[b]) if l == self.num_layers_per_block - 1
                     else 1)
                self.layers[f"block{b}_conv{l}"] = nn.Conv2d(
                    c_in, c_out, k, stride=s, padding=k // 2)
                freq = (freq + 2 * (k // 2) - k) // s + 1
                self.layers[f"block{b}_norm{l}"] = nn.LayerNorm(
                    (freq, c_out), eps=1e-5)
                c_in = c_out

    def forward(self, feats: torch.Tensor, train: bool = False,
                rng: Optional[StepRandom] = None) -> torch.Tensor:
        """feats (B, T, F) -> (B, T', F', C)."""
        x = feats[..., None]  # NHWC
        for b in range(self.num_blocks):
            for l in range(self.num_layers_per_block):
                residual_in = x
                conv = self.layers[f"block{b}_conv{l}"]
                x = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                x = F.leaky_relu(self.layers[f"block{b}_norm{l}"](x), 0.01)
                if train:
                    x = dropout(x, self.dropout, rng)
                if self.residuals[b] and residual_in.shape == x.shape:
                    x = x + residual_in
        return x
