"""Prompted, KV-cached batched beam search (the serving hot loop).

Port of ``stac_st_tpu/decoding/beam_search.py`` for the serving
configuration: the decoder is seeded with ``[bos, source_lang,
target_lang]``, then B·beam hypotheses advance one token per step with
temperature, the eos threshold gate, length normalization, ONE top-k over
beam·V (a hypothesis finishes only when eos itself wins a slot), a merged
finished set, an exact early exit, segmented cache growth and the
budget-normalized alive fallback. Hypotheses come back without prompt or
eos. ``kv_cache_dtype='int8'`` decodes with the int8 KV cache (its
scales per (row, head, position)). Joint-CTC and LM fusion and
``mask_encoder_padding`` are not ported: the constructor refuses them,
naming the field (``models.settings.require``).

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

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models.settings import require

__all__ = ["BeamSearchConfig", "beam_search", "MultiTaskBeamSearch",
           "plan_segments", "gather_rows"]

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


def beam_search(model, seq_lin, enc_out: torch.Tensor, prompt: torch.Tensor,
                max_steps: int, config: BeamSearchConfig,
                cache_growth: Optional[int] = None,
                kv_cache_dtype: Optional[str] = None):
    """Run the search.

    Args:
      model: ``TransformerMultiTask``; seq_lin: the output head.
      enc_out: (B, S, d) encoder output.
      prompt: (L,) int prompt for every row, or (B, L) per-utterance
        prompts (the fused multi-prompt decode).
      max_steps: step budget.
      cache_growth: first segment of the geometric cache growth, or None.
      kv_cache_dtype: None (anc mode at beam > 1) or 'int8' (gather mode).

    Returns tokens (B, max_steps) int64, lengths (B,), scores (B,).
    """
    B, S, _ = enc_out.shape
    beam = config.beam_size
    BB = B * beam
    dev = enc_out.device
    prompt_len = prompt.shape[-1]
    segments = plan_segments(max_steps, cache_growth)
    anc_mode = beam > 1 and kv_cache_dtype is None
    cache = model.init_decode_cache(enc_out, prompt_len + segments[0],
                                    beam=beam, anc_mode=anc_mode,
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
    norm_len = float(max_steps)

    def unsettled() -> torch.Tensor:
        bound = alive_scores.max(dim=1).values
        if config.length_normalization:
            bound = bound / norm_len
        return bound > fin_scores.max(dim=1).values

    t, settled = 0, False
    for si, seg_bound in enumerate(segments):
        if si:  # continue the same search in a larger cache
            model.grow_decode_cache(cache, prompt_len + seg_bound)
        while t < seg_bound:
            # early exit: stop once no alive beam can still beat its row's
            # best finished hypothesis (alive raw scores only decrease)
            if not bool(unsettled().any()):
                settled = True
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

            cum = alive_scores[:, :, None] + logp  # (B, beam, V)
            sel = cum / (t + 1.0) if config.length_normalization else cum
            sel_vals, flat_idx = _topk_stable(sel.reshape(B, beam * V), beam)
            parent = flat_idx // V
            new_tok = flat_idx % V
            new_cum = torch.gather(cum.reshape(B, beam * V), 1, flat_idx)
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
                gather_rows(cache, (flat_base + parent).reshape(-1))
            elif beam > 1:
                # anc mode: reorder only the ancestor table; the slot about
                # to be written maps to each hypothesis's own row
                anc = torch.gather(
                    cache["anc"], 1,
                    parent[:, :, None].expand(-1, -1, cache["anc"].shape[2]))
                anc[:, :, prompt_len + t] = beam_ids
                cache["anc"] = anc
            logits = step_logits(new_tok.reshape(BB), prompt_len + t)
            t += 1
        if settled:
            break

    # fallback: hypotheses that never emitted eos compete at the BUDGET
    # length (not the batch-global exit step, which would couple a row's
    # choice to its batch mates)
    alive_sel = (alive_scores / norm_len if config.length_normalization
                 else alive_scores)
    all_scores = torch.cat([fin_scores, alive_sel], dim=1)
    all_tokens = torch.cat([fin_tokens, alive_tokens], dim=1)
    all_lengths = torch.cat(
        [fin_lengths, torch.full_like(fin_lengths, t)], dim=1)
    best = torch.argmax(all_scores, dim=1)  # first occurrence
    rows = torch.arange(B, device=dev)
    return all_tokens[rows, best], all_lengths[rows, best], \
        all_scores[rows, best]


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
                 mask_encoder_padding: bool = False,
                 kv_cache_dtype: Optional[str] = None, **unused):
        """``modules`` (or a list as the first argument): [Transformer,
        seq_lin, ctc_lin], as the JAX searcher and the YAMLs take them;
        ``temperature_lm`` acts only with an LM, so it is accepted and
        unused."""
        if isinstance(model, (list, tuple)):
            modules, model = model, None
        ctc_lin = None
        if modules is not None:
            model, seq_lin = modules[0], modules[1]
            ctc_lin = modules[2] if len(modules) > 2 else None
        owner = "MultiTaskBeamSearch"
        require(owner, "ctc_weight", float(ctc_weight), 0.0)
        require(owner, "lm_weight", float(lm_weight), 0.0)
        require(owner, "mask_encoder_padding", bool(mask_encoder_padding),
                False)
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
            temperature=float(temperature),
        )
        self.bos_token = int(bos_index)
        self.max_decode_tokens = (int(max_decode_tokens)
                                  if max_decode_tokens else None)
        self.cache_growth = int(cache_growth) if cache_growth else None
        self.decoder_input_tokens: Optional[List[int]] = None

    # ---- the reference's prompt API ------------------------------------
    def set_decoder_prefix_tokens(self, source_lang: int,
                                  target_lang: int) -> None:
        self.decoder_input_tokens = [self.bos_token, int(source_lang),
                                     int(target_lang)]

    def __call__(self, enc_out: torch.Tensor, wav_lens=None):
        """Search under the prompt set by ``set_decoder_prefix_tokens``.
        Returns (hyps as lists of token ids, scores (B,) on the CPU).
        ``wav_lens`` is accepted as the JAX searcher takes it; like the
        reference's shipped decode path, the search does not mask encoder
        padding."""
        if self.decoder_input_tokens is None:
            raise RuntimeError("call set_decoder_prefix_tokens(src, tgt) "
                               "first")
        return self.call_multi(enc_out, wav_lens,
                               prompts=[self.decoder_input_tokens])[0]

    def max_steps(self, enc_frames: int) -> int:
        """min(⌊max_decode_ratio · S⌋, max_decode_tokens), at least 1."""
        steps = max(int(self.config.max_decode_ratio * enc_frames), 1)
        if self.max_decode_tokens is not None:
            steps = min(steps, self.max_decode_tokens)
        return steps

    @torch.inference_mode()
    def search(self, enc_out: torch.Tensor, prompt: torch.Tensor):
        """(tokens (B, steps), lengths (B,), scores (B,)) on enc_out's
        device; prompt (L,) or (B, L) int. ``enc_out`` is taken in the
        model's dtype (the trainer's fp32 weights search a bf16 forward's
        output in fp32, as JAX's type promotion does). Like the
        reference's shipped decode path, cross-attention does not mask
        encoder padding."""
        dtype = next(self.model.parameters()).dtype
        return beam_search(self.model, self.seq_lin, enc_out.to(dtype),
                           prompt.to(enc_out.device),
                           self.max_steps(enc_out.shape[1]), self.config,
                           cache_growth=self.cache_growth,
                           kv_cache_dtype=self.kv_cache_dtype)

    def call_multi(self, enc_out: torch.Tensor, wav_lens=None,
                   prompts: Sequence[Sequence[int]] = ()):
        """Decode the same encoder output under P prompts in ONE search:
        enc_out is tiled P× on the batch axis, tile p gets prompt p.
        Returns P (hyps, scores) pairs, hyps as lists of token ids.
        ``wav_lens`` as in ``__call__``."""
        pr = torch.as_tensor(prompts, dtype=torch.long)
        if pr.dim() != 2:
            raise ValueError("prompts must be a (P, L) token matrix")
        P, B = pr.shape[0], enc_out.shape[0]
        tokens, lengths, scores = self.search(
            torch.cat([enc_out] * P), pr.repeat_interleave(B, dim=0))
        tokens, lengths = tokens.cpu(), lengths.cpu()
        hyps = [tokens[i, : lengths[i]].tolist() for i in range(P * B)]
        scores = scores.cpu()
        return [(hyps[i * B:(i + 1) * B], scores[i * B:(i + 1) * B])
                for i in range(P)]
