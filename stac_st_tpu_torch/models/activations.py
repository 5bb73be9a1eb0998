"""Activation functions (port of ``stac_st_tpu/models/activations.py``).

``default_activation`` is what the JAX model uses when none is configured
(the serving presets): ``jax.nn.gelu`` with its default tanh
approximation. ``GELU`` is the exact form the reference YAML names
(``torch.nn.GELU``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["GELU", "default_activation"]


class GELU(nn.Module):
    """Exact (erf) GELU."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="none")


def default_activation(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
