"""CTC prefix scoring for joint CTC/attention decoding.

Port of ``stac_st_tpu/decoding/ctc_prefix.py`` (Watanabe et al., hybrid
CTC/attention). For a hypothesis prefix g and each candidate next token c
the scorer keeps the CTC forward variables over the frame axis, r_nb[t]
(paths ending in a non-blank emission of the last label) and r_b[t] (paths
ending in blank), and returns log p_ctc(g·c·… | x). The frame sweep of a
decode step is one kernel launch (``ops.kernels.ctc_prefix``) on the card
and its plain version on the CPU.

State per hypothesis: r_nb, r_b (BB, T) and the last label (-1 for the
empty prefix). Unlike the reference, which repeats the posteriors over the
beam, every function takes them once per utterance, (B, T, V), with
``beam`` saying how many rows share one: with ``beam=1`` each signature is
the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.kernels.ctc_prefix import NEG_INF, ctc_prefix_score

__all__ = ["CtcPrefixState", "ctc_prefix_init", "ctc_prefix_score_all",
           "ctc_prefix_select", "NEG_INF"]


class CtcPrefixState(NamedTuple):
    r_nb: torch.Tensor  # (BB, T) or (BB, K, T): paths ending non-blank
    r_b: torch.Tensor   # (BB, T) or (BB, K, T): paths ending blank
    last: torch.Tensor  # (BB,) int64 last label of the prefix (-1: empty)


def ctc_prefix_init(log_probs: torch.Tensor, blank: int = 0,
                    beam: int = 1) -> CtcPrefixState:
    """State of the empty prefix for B·beam rows; log_probs (B, T, V)."""
    r_b = torch.cumsum(log_probs[:, :, blank].float(), dim=1)
    r_b = r_b.repeat_interleave(beam, dim=0).contiguous()
    return CtcPrefixState(
        r_nb=torch.full_like(r_b, NEG_INF), r_b=r_b,
        last=torch.full((r_b.shape[0],), -1, dtype=torch.long,
                        device=r_b.device))


def ctc_prefix_score_all(state: CtcPrefixState, log_probs: torch.Tensor,
                         input_lengths: torch.Tensor, blank: int = 0,
                         eos: int = 2,
                         candidates: Optional[torch.Tensor] = None,
                         beam: int = 1
                         ) -> Tuple[torch.Tensor, CtcPrefixState,
                                    torch.Tensor]:
    """Score candidate continuations.

    state: the rows' prefixes (BB = B·beam rows); log_probs (B, T, V) CTC
    frame log-posteriors; input_lengths (BB,) valid frame counts;
    candidates: (BB, K) token ids (partial scoring), or None for the whole
    vocabulary.

    Returns scores (BB, K) log p_ctc(prefix·c·…|x) (an ``eos`` candidate
    gets the complete prefix's probability, ``blank`` -1e9), the candidates'
    state with (BB, K, T) variables (commit one per row with
    :func:`ctc_prefix_select`) and the (BB, K) candidate ids."""
    lp = log_probs.float().contiguous()
    BB, V = state.r_nb.shape[0], lp.shape[2]
    cand = None if candidates is None else candidates.long().contiguous()
    scores, nb_all, b_all = ctc_prefix_score(
        lp, state.r_nb.contiguous(), state.r_b.contiguous(),
        state.last.long().contiguous(), cand,
        input_lengths.long().contiguous(), blank, eos, beam)
    if cand is None:
        cand = torch.arange(V, device=lp.device).expand(BB, V)
    return scores, CtcPrefixState(nb_all, b_all, state.last), cand


def ctc_prefix_select(candidate_state: CtcPrefixState,
                      cand_ids: torch.Tensor, k_index: torch.Tensor,
                      rows: Optional[torch.Tensor] = None
                      ) -> CtcPrefixState:
    """Commit one candidate per row: row i takes candidate ``k_index[i]``
    of row ``rows[i]`` (of row i when ``rows`` is None; the search passes
    the flat parent of each new hypothesis). candidate_state holds
    (BB, K, T) variables. Returns a (BB, T) state."""
    nb_all, b_all, _ = candidate_state
    k = k_index.long()
    if rows is None:
        rows = torch.arange(k.shape[0], device=k.device)
    return CtcPrefixState(nb_all[rows, k], b_all[rows, k],
                          cand_ids[rows, k].long())
