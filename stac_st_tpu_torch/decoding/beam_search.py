"""Prompted, KV-cached batched beam search (the serving hot loop).

Port of ``stac_st_tpu/decoding/beam_search.py``: the decoder is seeded with
``[bos, source_lang, target_lang]``, then B·beam hypotheses advance one
token per step with temperature, the eos threshold gate, length
normalization, ONE top-k over the candidates (a hypothesis finishes only
when eos itself wins a slot), a merged finished set, an exact early exit,
segmented cache growth and the budget-normalized alive fallback.
Hypotheses come back without prompt or eos. ``kv_cache_dtype='int8'``
decodes with the int8 KV cache (its scales per (row, head, position)).

The searcher's options, as the reference has them:

* joint CTC/attention decoding (``ctc_weight`` > 0 with the CTC head's
  frame log-posteriors): the top beam attention candidates of each
  hypothesis, after the eos gate, plus eos are scored with the CTC prefix
  recursion (``decoding.ctc_prefix``, one kernel launch a step on the
  card), blended as (1 − w)·att + w·ctc, and one top-k over beam·(beam + 1)
  picks the hypotheses; the committed candidates' CTC state follows them;
* shallow LM fusion (``set_lm``, active while ``lm_weight`` > 0): the LM
  sees ``bos`` and the hypothesis, never the language prompt; its
  log-softmax over ``temperature_lm`` is added after the eos gate, and
  every state leaf whose leading dimension is B·beam follows the beam's
  reorder;
* ``mask_encoder_padding``: cross-attention masks encoder frames past
  floor(wav_len · S) (``ops.masks.src_key_padding_mask_encode``); without
  it, as the reference's shipped path, the search sees the padding;
* ``decode_tier`` (with ``max_decode_tokens``): a search at the tier's
  budget whose early-exit bound is normalized by the full budget, so a
  row it calls settled would decode the same under the full budget; the
  full budget runs again only when some row is unsettled (one host read).

``MultiTaskBeamSearch`` takes the YAML's form (``modules=[Transformer,
seq_lin, ctc_lin]``) or ``(model, seq_lin)``, and the reference's prompt
API (``set_decoder_prefix_tokens`` then ``__call__``), which the trainer's
validation and ``evaluate`` use. It searches with the modules' own
weights: the trainer's modules read its flat parameter buffer, so a
search always sees the current weights, without a bind or a copy.

Cache mode: beam 1 decodes with the Kᵀ/V layout and no reorder (the parent
of a single hypothesis is itself). A float cache at beam > 1 uses anc mode:
the K/V caches are never reordered, only the (B, beam, S) ancestor table
is. The int8 cache at beam > 1 uses gather mode, as the reference does on
its XLA path: after each top-k every per-row leaf of each layer's self
cache (K, V and their scales) is reordered by the flat parent index, then
the step appends at the shared index. Both modes compute the same
search; segmented growth applies to both.

Tie order: ``jax.lax.top_k`` puts the lower index first among equal
values, and the finished-set merge ties constantly on its NEG_INF entries,
so every top-k here is a stable descending sort. The final pick is
``argmax`` (first occurrence). The early exit reads one flag per step on
the host.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import masks as M
from .ctc_prefix import (
    ctc_prefix_init,
    ctc_prefix_score_all,
    ctc_prefix_select,
)

__all__ = ["BeamSearchConfig", "beam_search", "MultiTaskBeamSearch",
           "plan_segments", "gather_rows", "gather_state"]

NEG_INF = -1.0e9


class BeamSearchConfig(NamedTuple):
    beam_size: int = 5
    bos_index: int = 1
    eos_index: int = 2
    blank_index: int = 0
    min_decode_ratio: float = 0.0
    max_decode_ratio: float = 1.0
    using_eos_threshold: bool = False
    eos_threshold: float = 1.5
    length_normalization: bool = False
    temperature: float = 1.0
    ctc_weight: float = 0.0     # joint CTC/attention (ctc_weight_decode)
    lm_weight: float = 0.0      # shallow LM fusion
    temperature_lm: float = 1.0


def plan_segments(max_steps: int, first: Optional[int]) -> Tuple[int, ...]:
    """Geometric step-budget segments (first, 2·first, …, max_steps): the
    cache is allocated for the first and grown between segments, so the
    attention reads scale with the budget actually reached."""
    if not first or first >= max_steps:
        return (max_steps,)
    bounds, b = [], int(first)
    while b < max_steps:
        bounds.append(b)
        b *= 2
    bounds.append(max_steps)
    return tuple(bounds)


def _topk_stable(x: torch.Tensor, k: int):
    """Top-k along dim 1 with the lower index first among ties."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def gather_rows(cache, flat_parent: torch.Tensor) -> None:
    """Gather mode's reorder, in place of each layer's self cache: every
    per-row leaf (K, V and the int8 scales) takes the rows ``flat_parent``
    (B·beam,) names; the shared index stays."""
    for layer in cache["layers"]:
        sc = layer["self"]
        for name, leaf in sc.items():
            if name != "index":
                sc[name] = leaf.index_select(0, flat_parent)


def gather_state(state: Any, flat_parent: torch.Tensor) -> Any:
    """The LM state's reorder (the reference's ``default_cache_gather``):
    every tensor leaf of ``state`` (nested in dicts, lists and tuples)
    whose leading dimension is B·beam takes the rows ``flat_parent``
    names; other leaves stay."""
    rows = flat_parent.shape[0]
    if isinstance(state, torch.Tensor):
        if state.dim() >= 1 and state.shape[0] == rows:
            return state.index_select(0, flat_parent)
        return state
    if isinstance(state, dict):
        return {k: gather_state(v, flat_parent) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        out = [gather_state(v, flat_parent) for v in state]
        return type(state)(*out) if hasattr(state, "_fields") \
            else type(state)(out)
    return state


def beam_search(model, seq_lin, enc_out: torch.Tensor, prompt: torch.Tensor,
                max_steps: int, config: BeamSearchConfig,
                cache_growth: Optional[int] = None,
                kv_cache_dtype: Optional[str] = None,
                enc_bias: Optional[torch.Tensor] = None,
                ctc_log_probs: Optional[torch.Tensor] = None,
                ctc_input_lengths: Optional[torch.Tensor] = None,
                lm_step_fn: Optional[Callable] = None,
                lm_init_fn: Optional[Callable] = None,
                settled_bound_len: Optional[int] = None):
    """Run the search.

    Args:
      model: ``TransformerMultiTask``; seq_lin: the output head.
      enc_out: (B, S, d) encoder output.
      prompt: (L,) int prompt for every row, or (B, L) per-utterance
        prompts (the fused multi-prompt decode).
      max_steps: step budget.
      cache_growth: first segment of the geometric cache growth, or None.
      kv_cache_dtype: None (anc mode at beam > 1) or 'int8' (gather mode).
      enc_bias: (B, S) additive fp32 cross-attention bias, or None.
      ctc_log_probs: (B, T, V) CTC frame log-posteriors; joint CTC decoding
        when ``config.ctc_weight`` > 0. ctc_input_lengths: (B,) valid
        frames (all T when None).
      lm_step_fn: (tokens (BB,), position, state) -> (logits (BB, V),
        state), the LM bound to its weights; used while
        ``config.lm_weight`` > 0. lm_init_fn: (BB) -> state, or None (the
        state is then None).
      settled_bound_len: the length (>= max_steps) that normalizes the
        early-exit bound: max_steps (the default) certifies this budget, a
        larger value that the result would be the same under that budget.

    Returns tokens (B, max_steps) int64, lengths (B,), scores (B,) and
    settled (B,) bool: True where no alive hypothesis could still beat the
    row's best finished one under the bound's budget.
    """
    B, S, _ = enc_out.shape
    beam = config.beam_size
    BB = B * beam
    dev = enc_out.device
    prompt_len = prompt.shape[-1]
    segments = plan_segments(max_steps, cache_growth)
    anc_mode = beam > 1 and kv_cache_dtype is None
    cache = model.init_decode_cache(enc_out, prompt_len + segments[0],
                                    enc_mask_bias=enc_bias, beam=beam,
                                    anc_mode=anc_mode,
                                    cache_dtype=kv_cache_dtype)
    flat_base = torch.arange(B, device=dev)[:, None] * beam

    def step_logits(tokens: torch.Tensor, position: int) -> torch.Tensor:
        return seq_lin(model.decode_step(tokens, position, cache))

    # --- warm-up: feed the prompt through the cache ---
    logits = None
    for p in range(prompt_len):
        if prompt.dim() == 2:
            tok = prompt[:, p].repeat_interleave(beam)
        else:
            tok = prompt[p].expand(BB)
        logits = step_logits(tok.contiguous(), p)

    min_steps = int(config.min_decode_ratio * S)

    use_ctc = config.ctc_weight > 0.0 and ctc_log_probs is not None
    if use_ctc:
        # the posteriors stay one per utterance: row r reads r // beam
        ctc_lp = ctc_log_probs.to(dev, torch.float32).contiguous()
        lens = (ctc_input_lengths if ctc_input_lengths is not None
                else torch.full((B,), ctc_lp.shape[1]))
        ctc_lens = lens.to(dev, torch.long).repeat_interleave(beam)
        ctc_state = ctc_prefix_init(ctc_lp, config.blank_index, beam)

    use_lm = lm_step_fn is not None and config.lm_weight > 0.0
    if use_lm:
        t_lm = config.temperature_lm if config.temperature_lm > 0 else 1.0
        lm_state = lm_init_fn(BB) if lm_init_fn is not None else None
        # the LM consumes bos, not the language prompt
        lm_logits, lm_state = lm_step_fn(
            torch.full((BB,), config.bos_index, dtype=torch.long,
                       device=dev), 0, lm_state)
        lm_logp = torch.log_softmax(lm_logits.float() / t_lm, dim=-1)

    alive_tokens = torch.zeros((B, beam, max_steps), dtype=torch.long,
                               device=dev)
    alive_scores = torch.full((B, beam), NEG_INF, dtype=torch.float32,
                              device=dev)
    alive_scores[:, 0] = 0.0
    fin_tokens = torch.zeros_like(alive_tokens)
    fin_scores = torch.full((B, beam), NEG_INF, dtype=torch.float32,
                            device=dev)
    fin_lengths = torch.zeros((B, beam), dtype=torch.long, device=dev)
    beam_ids = torch.arange(beam, dtype=torch.int32, device=dev)
    # the settle bound's normalizer: max_steps certifies this budget,
    # settled_bound_len (>= max_steps) a larger one (tiering)
    norm_len = float(settled_bound_len or max_steps)
    if norm_len < max_steps:
        raise ValueError(f"settled_bound_len {settled_bound_len} < "
                         f"max_steps {max_steps}")

    def unsettled() -> torch.Tensor:
        bound = alive_scores.max(dim=1).values
        if config.length_normalization:
            bound = bound / norm_len
        return bound > fin_scores.max(dim=1).values

    t, done = 0, False
    for si, seg_bound in enumerate(segments):
        if si:  # continue the same search in a larger cache
            model.grow_decode_cache(cache, prompt_len + seg_bound)
        while t < seg_bound:
            # early exit: stop once no alive beam can still beat its row's
            # best finished hypothesis (alive raw scores only decrease; the
            # CTC prefix scores of a growing prefix too)
            if not bool(unsettled().any()):
                done = True
                break
            logp = torch.log_softmax(
                logits.float() / config.temperature, dim=-1
            ).reshape(B, beam, -1)
            V = logp.shape[-1]
            eos = config.eos_index
            # eos gate: the threshold (eos only when close to the best
            # token) and the min-steps floor
            eos_col = logp[:, :, eos]
            if config.using_eos_threshold:
                best = logp.max(dim=-1).values
                eos_ok = eos_col > config.eos_threshold * best
                eos_col = torch.where(eos_ok, eos_col, NEG_INF)
            if t < min_steps:
                eos_col = torch.full_like(eos_col, NEG_INF)
            logp[:, :, eos] = eos_col
            if use_lm:  # shallow fusion after the eos gate
                logp = logp + config.lm_weight * lm_logp.reshape(B, beam, -1)
                eos_col = logp[:, :, eos]

            if use_ctc:
                # the top beam attention candidates of each hypothesis, and
                # eos forced in (it may be there twice: the tie falls to
                # the lower index)
                K = beam + 1
                att_vals, att_ids = _topk_stable(logp.reshape(BB, V), K - 1)
                cand = torch.cat(
                    [att_ids, torch.full((BB, 1), eos, dtype=torch.long,
                                         device=dev)], dim=1)  # (BB, K)
                att_full = torch.cat(
                    [att_vals.reshape(B, beam, K - 1), eos_col[:, :, None]],
                    dim=2)
                ctc_scores, cand_state, _ = ctc_prefix_score_all(
                    ctc_state, ctc_lp, ctc_lens, config.blank_index, eos,
                    candidates=cand, beam=beam)
                blended = ((1.0 - config.ctc_weight) * att_full
                           + config.ctc_weight
                           * ctc_scores.reshape(B, beam, K))
                cum = alive_scores[:, :, None] + blended  # (B, beam, K)
                width = K
            else:
                cum = alive_scores[:, :, None] + logp  # (B, beam, V)
                width = V
            sel = cum / (t + 1.0) if config.length_normalization else cum
            sel_vals, flat_idx = _topk_stable(sel.reshape(B, beam * width),
                                              beam)
            parent = flat_idx // width
            new_cum = torch.gather(cum.reshape(B, beam * width), 1, flat_idx)
            flat_parent = (flat_base + parent).reshape(-1)
            if use_ctc:
                new_tok = torch.gather(cand.reshape(B, beam * K), 1,
                                       flat_idx)
                # commit: the parent's candidate row, then its k
                ctc_state = ctc_prefix_select(
                    cand_state, cand, (flat_idx % K).reshape(-1),
                    rows=flat_parent)
            else:
                new_tok = flat_idx % V
            is_eos = new_tok == eos

            parent_tokens = torch.gather(
                alive_tokens, 1, parent[:, :, None].expand(-1, -1, max_steps))

            # finished set: merge the eos winners, keep the top beam
            eos_sel = torch.where(is_eos, sel_vals, NEG_INF)
            all_fin_scores = torch.cat([fin_scores, eos_sel], dim=1)
            all_fin_tokens = torch.cat([fin_tokens, parent_tokens], dim=1)
            all_fin_lengths = torch.cat(
                [fin_lengths, torch.full_like(fin_lengths, t)], dim=1)
            fin_scores, fin_idx = _topk_stable(all_fin_scores, beam)
            fin_tokens = torch.gather(
                all_fin_tokens, 1,
                fin_idx[:, :, None].expand(-1, -1, max_steps))
            fin_lengths = torch.gather(all_fin_lengths, 1, fin_idx)

            # alive beams: eos winners die, the rest continue
            alive_tokens = parent_tokens
            alive_tokens[:, :, t] = new_tok
            alive_scores = torch.where(is_eos, NEG_INF, new_cum)

            if beam > 1 and not anc_mode:
                gather_rows(cache, flat_parent)
            elif beam > 1:
                # anc mode: reorder only the ancestor table; the slot about
                # to be written maps to each hypothesis's own row
                anc = torch.gather(
                    cache["anc"], 1,
                    parent[:, :, None].expand(-1, -1, cache["anc"].shape[2]))
                anc[:, :, prompt_len + t] = beam_ids
                cache["anc"] = anc
            logits = step_logits(new_tok.reshape(BB), prompt_len + t)
            if use_lm:
                lm_logits, lm_state = lm_step_fn(
                    new_tok.reshape(BB), t + 1,
                    gather_state(lm_state, flat_parent))
                lm_logp = torch.log_softmax(lm_logits.float() / t_lm, dim=-1)
            t += 1
        if done:
            break

    # fallback: hypotheses that never emitted eos compete at the bound's
    # BUDGET length (not the batch-global exit step, which would couple a
    # row's choice to its batch mates)
    alive_sel = (alive_scores / norm_len if config.length_normalization
                 else alive_scores)
    all_scores = torch.cat([fin_scores, alive_sel], dim=1)
    all_tokens = torch.cat([fin_tokens, alive_tokens], dim=1)
    all_lengths = torch.cat(
        [fin_lengths, torch.full_like(fin_lengths, t)], dim=1)
    best = torch.argmax(all_scores, dim=1)  # first occurrence
    rows = torch.arange(B, device=dev)
    return (all_tokens[rows, best], all_lengths[rows, best],
            all_scores[rows, best], ~unsettled())


class MultiTaskBeamSearch:
    """The searcher (port of the reference's ``MultiTaskBeamSearch``):
    holds the decode config and the modules; the prompt is runtime data,
    so one searcher serves ASR and ST."""

    def __init__(self, model=None, seq_lin=None, bos_index: int = 1,
                 eos_index: int = 2, blank_index: int = 0,
                 min_decode_ratio: float = 0.0,
                 max_decode_ratio: float = 1.0, beam_size: int = 5,
                 using_eos_threshold: bool = False,
                 eos_threshold: float = 1.5,
                 length_normalization: bool = False,
                 temperature: float = 1.0, ctc_weight: float = 0.0,
                 lm_weight: float = 0.0,
                 max_decode_tokens: Optional[int] = None,
                 cache_growth: Optional[int] = 64,
                 modules: Optional[Sequence[Any]] = None,
                 temperature_lm: float = 0.0,
                 source_lang: int = -100, target_lang: int = -100,
                 mask_encoder_padding: bool = False,
                 kv_cache_dtype: Optional[str] = None, **unused):
        """``modules`` (or a list as the first argument): [Transformer,
        seq_lin, ctc_lin], as the JAX searcher and the YAMLs take them.
        ``lm_weight`` acts once ``set_lm`` gives an LM; ``decode_tier`` is
        an attribute (None: off), as in the reference."""
        if isinstance(model, (list, tuple)):
            modules, model = model, None
        ctc_lin = None
        if modules is not None:
            model, seq_lin = modules[0], modules[1]
            ctc_lin = modules[2] if len(modules) > 2 else None
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype: {kv_cache_dtype!r} "
                             "(supported: None, 'int8')")
        self.kv_cache_dtype = kv_cache_dtype
        self.model, self.seq_lin, self.ctc_lin = model, seq_lin, ctc_lin
        self.config = BeamSearchConfig(
            beam_size=int(beam_size), bos_index=int(bos_index),
            eos_index=int(eos_index), blank_index=int(blank_index),
            min_decode_ratio=float(min_decode_ratio),
            max_decode_ratio=float(max_decode_ratio),
            using_eos_threshold=bool(using_eos_threshold),
            eos_threshold=float(eos_threshold),
            length_normalization=bool(length_normalization),
            temperature=float(temperature), ctc_weight=float(ctc_weight),
            lm_weight=float(lm_weight),
            temperature_lm=float(temperature_lm),
        )
        self.mask_encoder_padding = bool(mask_encoder_padding)
        self.bos_token = int(bos_index)
        self.source_lang = int(source_lang)
        self.target_lang = int(target_lang)
        self.max_decode_tokens = (int(max_decode_tokens)
                                  if max_decode_tokens else None)
        # tiered decoding: with a serving cap, search at this budget first
        # and rerun the full budget only if some row is unsettled
        self.decode_tier: Optional[int] = None
        # whether the last call's tier pass settled (None: no tier pass)
        self.last_tier_settled: Optional[bool] = None
        self.cache_growth = int(cache_growth) if cache_growth else None
        self.decoder_input_tokens: Optional[List[int]] = None
        self._lm_step_fn: Optional[Callable] = None
        self._lm_init_fn: Optional[Callable] = None

    # ---- the reference's prompt API ------------------------------------
    def set_source_language(self, source_lang: int) -> None:
        self.source_lang = int(source_lang)

    def set_target_language(self, target_lang: int) -> None:
        self.target_lang = int(target_lang)

    def set_decoder_prefix_tokens(self, source_lang: int,
                                  target_lang: int) -> None:
        self.set_source_language(source_lang)
        self.set_target_language(target_lang)
        self.decoder_input_tokens = [self.bos_token, self.source_lang,
                                     self.target_lang]

    # ---- LM fusion -----------------------------------------------------
    def set_lm(self, lm_step_fn: Callable, lm_init_fn: Optional[Callable],
               lm_params: Any, lm_weight: Optional[float] = None) -> None:
        """Plug an LM for shallow fusion: ``lm_step_fn(lm_params, tokens
        (BB,), position, state) -> (logits (BB, V), state)`` and
        ``lm_init_fn(lm_params, bb) -> state`` (or None: no state), torch
        callables on the search's device. Fusion acts while ``lm_weight``
        (here, or the constructor's) is > 0."""
        self._lm_step_fn = (
            lambda tokens, position, state:
            lm_step_fn(lm_params, tokens, position, state))
        self._lm_init_fn = (None if lm_init_fn is None
                            else lambda bb: lm_init_fn(lm_params, bb))
        if lm_weight is not None:
            self.config = self.config._replace(lm_weight=float(lm_weight))

    def __call__(self, enc_out: torch.Tensor, wav_lens=None,
                 ctc_log_probs: Optional[torch.Tensor] = None):
        """Search under the prompt set by ``set_decoder_prefix_tokens``.
        Returns (hyps as lists of token ids, scores (B,) on the CPU).
        ``wav_lens`` (B,) relative lengths: the padding mask (with
        ``mask_encoder_padding``) and the CTC frames (floor(wav_len · T));
        ``ctc_log_probs`` (B, T, V): the CTC head's frame log-posteriors
        for joint decoding (used when ``ctc_weight`` > 0)."""
        if self.decoder_input_tokens is None:
            raise RuntimeError("call set_decoder_prefix_tokens(src, tgt) "
                               "first")
        return self.call_multi(enc_out, wav_lens,
                               prompts=[self.decoder_input_tokens],
                               ctc_log_probs=ctc_log_probs)[0]

    def max_steps(self, enc_frames: int) -> int:
        """min(⌊max_decode_ratio · S⌋, max_decode_tokens), at least 1."""
        steps = max(int(self.config.max_decode_ratio * enc_frames), 1)
        if self.max_decode_tokens is not None:
            steps = min(steps, self.max_decode_tokens)
        return steps

    @torch.inference_mode()
    def search(self, enc_out: torch.Tensor, prompt: torch.Tensor,
               wav_lens=None, ctc_log_probs: Optional[torch.Tensor] = None,
               max_steps: Optional[int] = None,
               settled_bound_len: Optional[int] = None):
        """One search, no tiering: (tokens (B, steps), lengths (B,),
        scores (B,), settled (B,)) on enc_out's device; prompt (L,) or
        (B, L) int; ``wav_lens`` and ``ctc_log_probs`` as in ``__call__``;
        ``max_steps`` defaults to :meth:`max_steps`. ``enc_out`` is taken
        in the model's dtype (the trainer's fp32 weights search a bf16
        forward's output in fp32, as JAX's type promotion does)."""
        dtype = next(self.model.parameters()).dtype
        dev = enc_out.device
        S = enc_out.shape[1]
        enc_bias = ctc_lens = None
        if wav_lens is not None:
            wl = torch.as_tensor(wav_lens, dtype=torch.float32, device=dev)
            if self.mask_encoder_padding:
                enc_bias = M.additive_bias(
                    M.src_key_padding_mask_encode(wl, S))
            if ctc_log_probs is not None:
                ctc_lens = torch.floor(wl * ctc_log_probs.shape[1]).long()
        return beam_search(
            self.model, self.seq_lin, enc_out.to(dtype), prompt.to(dev),
            max_steps or self.max_steps(S), self.config,
            cache_growth=self.cache_growth,
            kv_cache_dtype=self.kv_cache_dtype, enc_bias=enc_bias,
            ctc_log_probs=ctc_log_probs, ctc_input_lengths=ctc_lens,
            lm_step_fn=self._lm_step_fn, lm_init_fn=self._lm_init_fn,
            settled_bound_len=settled_bound_len)

    def _search_tiered(self, enc_out, prompt, wav_lens, ctc_log_probs):
        """``decode_tier``'s rule: with a serving cap and min_steps < tier
        < the full budget, a tier pass certified against the full budget;
        the full budget again only if some row is unsettled."""
        S = enc_out.shape[1]
        full = self.max_steps(S)
        tier = self.decode_tier if self.max_decode_tokens is not None \
            else None
        self.last_tier_settled = None
        if tier is not None and \
                int(self.config.min_decode_ratio * S) < tier < full:
            out = self.search(enc_out, prompt, wav_lens, ctc_log_probs,
                              max_steps=tier, settled_bound_len=full)
            self.last_tier_settled = bool(out[3].all())
            if self.last_tier_settled:
                return out
        return self.search(enc_out, prompt, wav_lens, ctc_log_probs,
                           max_steps=full)

    def call_multi(self, enc_out: torch.Tensor, wav_lens=None,
                   prompts: Sequence[Sequence[int]] = (),
                   ctc_log_probs: Optional[torch.Tensor] = None):
        """Decode the same encoder output under P prompts in ONE search:
        enc_out (and wav_lens, ctc_log_probs) is tiled P× on the batch
        axis, tile p gets prompt p. Returns P (hyps, scores) pairs, hyps as
        lists of token ids. ``wav_lens``, ``ctc_log_probs`` as in
        ``__call__``."""
        pr = torch.as_tensor(prompts, dtype=torch.long)
        if pr.dim() != 2:
            raise ValueError("prompts must be a (P, L) token matrix")
        P, B = pr.shape[0], enc_out.shape[0]
        wl = None if wav_lens is None else torch.cat(
            [torch.as_tensor(wav_lens, dtype=torch.float32)] * P)
        ctc_t = None if ctc_log_probs is None else torch.cat(
            [ctc_log_probs] * P)
        tokens, lengths, scores, _ = self._search_tiered(
            torch.cat([enc_out] * P), pr.repeat_interleave(B, dim=0), wl,
            ctc_t)
        tokens, lengths = tokens.cpu(), lengths.cpu()
        hyps = [tokens[i, : lengths[i]].tolist() for i in range(P * B)]
        scores = scores.cpu()
        return [(hyps[i * B:(i + 1) * B], scores[i * B:(i + 1) * B])
                for i in range(P)]
