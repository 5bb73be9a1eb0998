"""CTC loss on relative-length batches (port of ``stac_st_tpu/ops/ctc.py``).

The reference computes ``optax.ctc_loss``, whose forward algorithm floors
impossible paths at ``log_epsilon = −1e5`` instead of −inf: a row whose
targets cannot fit its frames gets a large FINITE loss there (about 1e5
per missing frame), where ``torch.nn.functional.ctc_loss`` gives inf. The
difference matters: a nonfinite loss makes the optimizer skip the step.

So every row whose target fits its frames (labels plus repeats <= frames,
at least one frame) goes through ``F.ctc_loss`` (the same exact forward
algorithm, and a fused backward); the other rows, if the batch has any,
go through :func:`ctc_forward_floor`, the optax algorithm written out in
torch, and autograd. Deciding that reads one flag back from the device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss", "ctc_forward_floor", "LOG_EPSILON"]

LOG_EPSILON = -1e5  # optax's stand-in for log(0)


def ctc_forward_floor(logprobs: torch.Tensor, in_len: torch.Tensor,
                      labels: torch.Tensor, lab_len: torch.Tensor,
                      blank: int = 0,
                      log_eps: float = LOG_EPSILON) -> torch.Tensor:
    """Per-row CTC loss with optax's floored forward algorithm.

    logprobs (B, T, C) normalised; in_len, lab_len (B,) absolute lengths;
    labels (B, N) right-padded. Follows ``optax.ctc_loss_with_forward_probs``
    step for step (blank/label alpha states, repeat handling, padded
    frames carry the state)."""
    B, T, _ = logprobs.shape
    N = labels.shape[1]
    dev = logprobs.device
    labels = labels.long()
    logit_pad = (torch.arange(T, device=dev)[None, :]
                 >= in_len[:, None]).to(logprobs.dtype)  # (B, T)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype)
    repeat = F.pad(repeat, (0, 1))  # (B, N)
    lp_phi = logprobs[:, :, blank]  # (B, T)
    lp_emit = torch.gather(logprobs, 2,
                           labels[:, None, :].expand(B, T, N))  # (B, T, N)
    phi = torch.full((B, N + 1), log_eps, dtype=logprobs.dtype, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_eps, dtype=logprobs.dtype, device=dev)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)], dim=1)

    for t in range(T):
        prev_phi = add_phi(phi, emit + log_eps * repeat)
        e_t = lp_emit[:, t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e_t, emit + e_t)
        b_t = lp_phi[:, t:t + 1]
        next_phi = add_phi(prev_phi + b_t,
                           emit + b_t + log_eps * (1.0 - repeat))
        pad = logit_pad[:, t:t + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * phi + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    return -torch.gather(last, 1, lab_len.long()[:, None])[:, 0]


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             input_lens: torch.Tensor, target_lens: torch.Tensor,
             blank_index: int = 0, reduction: str = "mean",
             n_rows: Optional[int] = None):
    """CTC loss. log_probs (B, T, C) log-probabilities (or logits: they are
    log-softmaxed again, which changes nothing); targets (B, U) zero-padded;
    input_lens, target_lens (B,) relative lengths, made absolute with
    ``round``. Reductions as the reference (``mean`` divides each row by
    its target length first). ``n_rows``: the global batch's row count,
    which divides ``mean`` and ``batchmean`` in a data-parallel rank's
    share (padding rows count, as in the JAX mesh step)."""
    B, T, _ = log_probs.shape
    U = targets.shape[1]
    abs_in = torch.round(input_lens.to(torch.float32) * T).long()
    abs_tgt = torch.round(target_lens.to(torch.float32) * U).long()
    lp = torch.log_softmax(log_probs.to(torch.float32), dim=-1)
    tgt = targets.long()
    pos = torch.arange(1, U, device=tgt.device)[None, :]
    repeats = ((tgt[:, 1:] == tgt[:, :-1]) & (pos < abs_tgt[:, None])).sum(1)
    fits = (abs_tgt + repeats <= abs_in) & (abs_in > 0)
    # infeasible rows get 0 from torch (zero_infinity) and are replaced
    per_seq = F.ctc_loss(lp.transpose(0, 1), tgt, abs_in, abs_tgt,
                         blank=blank_index, reduction="none",
                         zero_infinity=True)
    if not bool(fits.all()):
        rows = torch.nonzero(~fits)[:, 0]
        floor = ctc_forward_floor(lp[rows], abs_in[rows], tgt[rows],
                                  abs_tgt[rows], blank_index)
        per_seq = per_seq.index_put((rows,), floor)
    if reduction == "mean":
        per_tok = per_seq / torch.clamp(abs_tgt, min=1)
        return torch.mean(per_tok) if n_rows is None \
            else per_tok.sum() / n_rows
    if reduction == "batchmean":
        return per_seq.sum() / (n_rows or B)
    if reduction == "batch":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    raise ValueError(f"unknown reduction {reduction!r}")
