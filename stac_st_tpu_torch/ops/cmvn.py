"""Global CMVN with epoch-gated running statistics (port of
``stac_st_tpu/ops/cmvn.py``).

Training folds each batch into the running stats until
``update_until_epoch`` (``InputNormalization.should_update``), then
freezes them; serving only applies them. The running stats are the
arithmetic mean of all PER-UTTERANCE means and stds seen so far (not a
pooled std): a batch update is ``(stat · count + Σ_batch) / (count + B)``,
B counting every row of the batch tensor, as the JAX step counts the
zero-length rows that pad a batch to its mesh (each adds mean 0 and std
√eps). Over ranks, the sums and B are the global batch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["CmvnState", "InputNormalization", "cmvn_init", "cmvn_apply",
           "cmvn_update"]

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


def _per_utt_stats(feats: torch.Tensor, rel_lengths: torch.Tensor):
    """Masked per-utterance mean/std over time, abs_len = round(rel · T).
    feats (B, T, D) -> (B, D), (B, D)."""
    T = feats.shape[1]
    abs_len = torch.round(rel_lengths.to(torch.float32) * T)
    mask = (torch.arange(T, device=feats.device)[None, :]
            < abs_len[:, None]).to(torch.float32)
    denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)  # (B, 1)
    mean = (feats * mask[..., None]).sum(1) / denom
    var = (((feats - mean[:, None, :]) ** 2) * mask[..., None]).sum(1) / denom
    return mean, torch.sqrt(torch.clamp(var, min=_EPS))


def cmvn_update(state: CmvnState, feats: torch.Tensor,
                rel_lengths: torch.Tensor, reduce_sum=None,
                n_rows: Optional[int] = None) -> CmvnState:
    """Fold a batch of utterances into the running stats. With
    ``reduce_sum`` (an in-place sum over ranks) the batch is this rank's
    rows of a global batch of ``n_rows``."""
    mean_b, std_b = _per_utt_stats(feats, rel_lengths)
    mean_s, std_s = mean_b.sum(0), std_b.sum(0)
    if reduce_sum is not None:
        mean_s, std_s = reduce_sum(torch.stack([mean_s, std_s]))
    count = state.count + float(n_rows or feats.shape[0])
    mean = (state.mean * state.count + mean_s) / count
    std = (state.std * state.count + std_s) / count
    return CmvnState(mean, std, count)


class InputNormalization:
    """The hparams-facing spec (global norm, epoch-gated update); the
    statistics themselves live in a :class:`CmvnState`."""

    def __init__(self, norm_type: str = "global",
                 update_until_epoch: int = 4, **unused):
        if norm_type != "global":
            raise NotImplementedError("only norm_type 'global' is supported")
        self.norm_type = norm_type
        self.update_until_epoch = int(update_until_epoch)

    def init_state(self, dim: int, device="cpu") -> CmvnState:
        return cmvn_init(dim, device)

    def should_update(self, epoch: int) -> bool:
        """Stats update while epoch < update_until_epoch."""
        return epoch < self.update_until_epoch
