"""Global CMVN apply (port of ``stac_st_tpu/ops/cmvn.py``).

Serving only normalizes with frozen statistics; the running update
(``cmvn_update``) belongs to the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CmvnState", "cmvn_init", "cmvn_apply"]

_EPS = 1e-10


class CmvnState(NamedTuple):
    mean: torch.Tensor   # (D,) fp32
    std: torch.Tensor    # (D,) fp32
    count: torch.Tensor  # () fp32, utterances folded in

    def to(self, device) -> "CmvnState":
        return CmvnState(*(t.to(device) for t in self))


def cmvn_init(dim: int, device="cpu") -> CmvnState:
    return CmvnState(
        mean=torch.zeros((dim,), dtype=torch.float32, device=device),
        std=torch.ones((dim,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.float32, device=device),
    )


def cmvn_apply(state: CmvnState, feats: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (feats - mean) / max(std, eps)."""
    std = torch.clamp(state.std, min=_EPS)
    return (feats - state.mean[None, None, :]) / std[None, None, :]
