"""Speculative (draft-verify) greedy decoding: the target's greedy decode
in fewer target steps.

Port of ``stac_st_tpu/decoding/speculative.py``. A cheaper draft model
proposes ``k`` tokens one step at a time; the target verifies the whole
window in ONE windowed decode step (``TransformerMultiTask.decode_window``)
and the longest agreeing prefix is accepted, plus the target's own token at
the first disagreement. Every emitted token is a target argmax given the
same prefix, so the output is the target's greedy decode token for token,
whatever the draft proposes; the draft changes only the number of target
steps. Both caches are then rewound to the accepted length
(``set_cache_index``): rows past it are masked and overwritten by the next
window.

One utterance (B = 1) at a time, as in the reference: divergent accept
counts across rows would need per-row write indices. The loop runs on
the host, one round per iteration, and reads the device once a round
(the target's k predictions beside the draft's k proposals).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

__all__ = ["SpecBound", "SpecResult", "bind_spec_model",
           "speculative_greedy_search"]


class SpecBound(NamedTuple):
    """A model bound for speculative decoding."""

    init_cache: Callable  # (enc_out, max_len, enc_bias) -> cache
    step: Callable        # (tokens (B,), position, cache) -> logits (B, V)
    window: Callable      # (tokens (B, w), position, cache) -> (B, w, V)
    set_index: Callable   # (cache, index) -> None


def bind_spec_model(model, seq_lin,
                    kv_cache_dtype: Optional[str] = None) -> SpecBound:
    """Bind a (``TransformerMultiTask``, ``LinearHead``) pair for
    speculation; either may hold int8 weights, and the cache may be int8.
    Caches are beam-1 layout and updated in place."""

    def init_cache(enc_out, max_len, enc_bias=None):
        return model.init_decode_cache(enc_out, max_len, enc_bias,
                                       cache_dtype=kv_cache_dtype)

    def step(tokens, position, cache):
        return seq_lin(model.decode_step(tokens, position, cache))

    def window(tokens, position, cache):
        return seq_lin(model.decode_window(tokens, position, cache))

    return SpecBound(init_cache, step, window, model.set_cache_index)


class SpecResult(NamedTuple):
    tokens: torch.Tensor  # (max_steps,) int64 on the CPU, prompt excluded
    length: int           # tokens generated, eos included if emitted
    target_steps: int     # target dispatches: windows, plus the prefill
    drafted: int          # draft tokens proposed


def speculative_greedy_search(
    target: SpecBound,
    draft: SpecBound,
    enc_target: torch.Tensor,
    enc_draft: torch.Tensor,
    prompt: torch.Tensor,
    max_steps: int,
    k: int = 4,
    eos_index: int = 2,
    enc_bias_target: Optional[torch.Tensor] = None,
    enc_bias_draft: Optional[torch.Tensor] = None,
) -> SpecResult:
    """Greedy-decode ``target`` exactly, ``k`` draft tokens per verify
    step.

    enc_target / enc_draft: (1, S, d) from each model's own encoder (the
    two share only the tokenizer). prompt: (P,) ``[bos, src_lang,
    tgt_lang]``. Returns the generated tokens only, cut after the first
    eos (inclusive); the caches hold ``P + max_steps + k`` positions, since
    a window may run up to k - 1 rows past the budget."""
    if k < 1 or max_steps < 1:
        raise ValueError(f"k {k} and max_steps {max_steps} must be >= 1")
    dev = enc_target.device
    prompt = prompt.reshape(-1).to(dev)
    P = prompt.shape[0]
    budget = P + max_steps + k
    d_dev = enc_draft.device
    t_cache = target.init_cache(enc_target, budget, enc_bias_target)
    d_cache = draft.init_cache(enc_draft, budget, enc_bias_draft)

    # prefill: feed prompt[:-1]; ``last`` stays unfed
    prefill_steps = 0
    if P > 1:
        target.window(prompt[None, :-1], 0, t_cache)
        draft.window(prompt[None, :-1].to(d_dev), 0, d_cache)
        prefill_steps = 1
    last = prompt[-1:]

    buf: List[int] = [0] * (max_steps + k)
    n_gen = iters = 0
    done = False
    while not done:
        idx = P - 1 + n_gen  # cache write index == tokens consumed
        tok, proposed = last.to(d_dev), []
        for i in range(k):
            tok = torch.argmax(draft.step(tok, idx + i, d_cache), dim=-1)
            proposed.append(tok)
        d_toks = torch.cat(proposed).to(dev)  # (k,)
        # verify window [last, d_0 .. d_{k-2}] -> the target's k predictions
        win = torch.cat([last, d_toks[:-1]])[None, :]
        preds = torch.argmax(target.window(win, idx, t_cache)[0], dim=-1)
        pred_l, draft_l = torch.stack([preds, d_toks]).tolist()
        # the agreeing prefix and the target's token at the first
        # disagreement; an eos in that run cuts it (inclusive)
        m = next((j + 1 for j in range(k) if pred_l[j] != draft_l[j]), k)
        eos_at = next((j for j in range(m) if pred_l[j] == eos_index), None)
        if eos_at is not None:
            m = eos_at + 1
        m = min(m, max_steps - n_gen)
        buf[n_gen:n_gen + k] = pred_l
        n_gen += m
        target.set_index(t_cache, idx + m)
        draft.set_index(d_cache, idx + m)
        last = preds[m - 1:m]
        done = eos_at is not None or n_gen >= max_steps
        iters += 1
    return SpecResult(tokens=torch.tensor(buf[:max_steps]), length=n_gen,
                      target_steps=iters + prefill_steps, drafted=iters * k)
