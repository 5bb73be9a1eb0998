"""Activation functions (port of ``stac_st_tpu/models/activations.py``).

``default_activation`` is what the JAX model uses when none is configured
(the serving presets): ``jax.nn.gelu`` with its default tanh
approximation. ``GELU`` is the exact form the reference YAML names
(``torch.nn.GELU``); ``ReLU``, ``LeakyReLU`` and ``Swish`` are the other
names the YAMLs may give. A YAML passes the class (``!name:``); the model
instantiates it.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["GELU", "ReLU", "LeakyReLU", "Swish", "default_activation"]


class GELU(nn.Module):
    """Exact (erf) GELU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="none")


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = float(negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)


class Swish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(x)


def default_activation(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
