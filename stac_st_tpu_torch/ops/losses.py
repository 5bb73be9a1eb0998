"""Sequence losses: label-smoothed NLL, masked reductions.

Port of ``stac_st_tpu/ops/losses.py`` (SpeechBrain semantics):

* per-token NLL over log-probabilities, masked by relative lengths with
  ``round`` (``length_mask``);
* label smoothing ``ls · reg + (1 − ls) · nll`` where
  ``reg = −Σ(mean_vocab(logp) · mask) / Σ mask``: the smoothing term is
  normalised by the token count whatever the reduction;
* reductions ``mean`` (token mean), ``batchmean`` (sum / batch), ``batch``
  (per-utterance mean) and ``sum``;
* ``LogSoftmax``, what the YAML's ``torch.nn.LogSoftmax`` resolves to.

A data-parallel rank computes its share of the global batch's loss:
``n_rows`` and ``n_tokens`` give the global row and token counts that
replace its own in the normalizers, so the ranks' shares sum to the
loss of the whole batch on one device.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["length_mask", "nll_loss", "kldiv_loss", "LogSoftmax"]


class LogSoftmax:
    """Callable matching ``torch.nn.LogSoftmax`` instantiation from YAML."""

    def __init__(self, dim: int = -1):
        self.dim = dim

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(x, dim=self.dim)


def length_mask(rel_lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) relative lengths -> (B, max_len) fp32 mask,
    abs_len = round(rel · max_len)."""
    abs_len = torch.round(rel_lengths.to(torch.float32) * max_len)
    idx = torch.arange(max_len, device=rel_lengths.device)
    return (idx[None, :] < abs_len[:, None]).to(torch.float32)


def _reduce(per_token: torch.Tensor, mask: torch.Tensor, reduction: str,
            n_rows=None, n_tokens=None):
    total = torch.sum(per_token * mask)
    if reduction == "mean":
        return total / torch.clamp(
            mask.sum() if n_tokens is None else n_tokens, min=1.0)
    if reduction == "batchmean":
        return total / (n_rows or per_token.shape[0])
    if reduction == "batch":
        dims = tuple(range(1, per_token.dim()))
        return (per_token * mask).sum(dims) / torch.clamp(mask.sum(dims),
                                                          min=1.0)
    if reduction == "sum":
        return total
    raise ValueError(f"unknown reduction {reduction!r}")


def nll_loss(log_probabilities: torch.Tensor, targets: torch.Tensor,
             length: Optional[torch.Tensor] = None,
             label_smoothing: float = 0.0, reduction: str = "mean",
             n_rows: Optional[int] = None,
             n_tokens: Optional[torch.Tensor] = None):
    """Negative log-likelihood over (B, T, C) log-probs, (B, T) targets;
    ``n_rows``/``n_tokens``: the global batch's counts (module note)."""
    B, T, _ = log_probabilities.shape
    targets = targets[..., :T].long()
    if length is not None:
        mask = length_mask(length, T)
    else:
        mask = torch.ones((B, T), dtype=torch.float32,
                          device=log_probabilities.device)
    picked = torch.gather(log_probabilities, -1, targets[..., None])[..., 0]
    nll = _reduce(-picked, mask, reduction, n_rows, n_tokens)
    if label_smoothing > 0.0:
        reg = -torch.sum(log_probabilities.mean(-1) * mask) / torch.clamp(
            mask.sum() if n_tokens is None else n_tokens, min=1.0)
        return label_smoothing * reg + (1.0 - label_smoothing) * nll
    return nll


def kldiv_loss(log_probabilities, targets, length=None,
               label_smoothing: float = 0.0, reduction: str = "mean",
               pad_idx: int = 0):
    """SpeechBrain's label-smoothed NLL twin."""
    return nll_loss(log_probabilities, targets, length=length,
                    label_smoothing=label_smoothing, reduction=reduction)
