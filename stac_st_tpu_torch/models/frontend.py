"""Convolutional front end (port of ``stac_st_tpu/models/frontend.py``).

Two blocks of Conv2d (kernel 3, stride 2, symmetric ``k//2`` padding) ->
LayerNorm -> LeakyReLU(0.01) -> Dropout over (time, freq), no residuals:
100 Hz fbank frames become 25 Hz encoder frames and 80 mels become 20.
Dropout is active only when the caller passes ``train=True`` with a
:class:`~stac_st_tpu_torch.models.dropout.StepRandom`.

The constructor also takes the YAML's keywords (``input_shape``, whose
last entry is ``n_mels``; ``num_blocks``; ``num_layers_per_block``;
``residuals``) and refuses, naming the field, what the port does not run:
a residual, more than one layer a block, or ``num_blocks`` other than
``len(out_channels)``.

The JAX module is NHWC with H = time and W = freq. Activations stay in that
layout here and are permuted to NCHW only around each convolution, so the
LayerNorm reduces over (freq, channel) jointly with (F, C)-shaped scale and
bias (eps 1e-5), and the output (B, T', F', C) flattens to F'·C features in
the same order as the reference's ``_flatten_src``.
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
        if num_blocks is not None:
            require(owner, "num_blocks", int(num_blocks), len(out_channels))
        require(owner, "num_layers_per_block", int(num_layers_per_block), 1)
        for b, residual in enumerate(residuals or ()):
            require(owner, f"residuals[{b}]", bool(residual), False)
        self.dropout = float(dropout)
        self.layers = nn.ModuleDict()
        freq, c_in = n_mels, 1
        for b, (c_out, k, s) in enumerate(zip(out_channels, kernel_sizes,
                                              strides)):
            self.layers[f"block{b}_conv0"] = nn.Conv2d(
                c_in, c_out, k, stride=s, padding=k // 2)
            freq = (freq + 2 * (k // 2) - k) // s + 1
            self.layers[f"block{b}_norm0"] = nn.LayerNorm((freq, c_out),
                                                          eps=1e-5)
            c_in = c_out
        self.num_blocks = len(out_channels)

    def forward(self, feats: torch.Tensor, train: bool = False,
                rng: Optional[StepRandom] = None) -> torch.Tensor:
        """feats (B, T, F) -> (B, T', F', C)."""
        x = feats[..., None]  # NHWC
        for b in range(self.num_blocks):
            conv = self.layers[f"block{b}_conv0"]
            x = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            x = F.leaky_relu(self.layers[f"block{b}_norm0"](x), 0.01)
            if train:
                x = dropout(x, self.dropout, rng)
        return x
