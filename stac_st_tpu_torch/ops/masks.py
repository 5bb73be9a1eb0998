"""Attention/padding masks (port of ``stac_st_tpu/ops/masks.py``).

Masks are boolean with True = masked, converted to an additive bias of
``NEG_INF = -1e9`` at the attention op (a finite bias, not ``-inf``, so a
fully masked row stays finite exactly as in the reference).
"""

from __future__ import annotations

import torch

__all__ = [
    "NEG_INF",
    "src_key_padding_mask",
    "src_key_padding_mask_encode",
    "tgt_key_padding_mask",
    "lookahead_mask",
    "additive_bias",
]

NEG_INF = -1e9


def src_key_padding_mask(rel_lengths: torch.Tensor,
                         max_len: int) -> torch.Tensor:
    """Training-forward variant: abs_len = round(rel · max_len) (half to
    even, as ``jnp.round``), position p is padding iff p >= abs_len.
    (B,) -> (B, max_len) bool."""
    abs_len = torch.round(rel_lengths.to(torch.float32) * max_len)
    pos = torch.arange(max_len, device=rel_lengths.device)
    return pos[None, :] >= abs_len[:, None]


def src_key_padding_mask_encode(rel_lengths: torch.Tensor,
                                max_len: int) -> torch.Tensor:
    """Reference ``encode()`` variant: abs_len = floor(rel · max_len), and
    position p is padding iff p > abs_len (strict ``>``: frame abs_len is
    kept). (B,) -> (B, max_len) bool."""
    abs_len = torch.floor(rel_lengths.to(torch.float32) * max_len)
    pos = torch.arange(max_len, device=rel_lengths.device)
    return pos[None, :] > abs_len[:, None]


def tgt_key_padding_mask(tokens: torch.Tensor,
                         pad_idx: int = 0) -> torch.Tensor:
    """True where tokens == pad. (B, T) bool."""
    return tokens == pad_idx


def lookahead_mask(size: int, device=None) -> torch.Tensor:
    """(T, T) bool, True above the diagonal (future positions masked)."""
    return torch.triu(
        torch.ones((size, size), dtype=torch.bool, device=device), diagonal=1)


def additive_bias(mask: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """bool mask (True = masked) -> additive attention bias."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, torch.full_like(zero, NEG_INF), zero)
