"""Text/token pipeline: prompt construction with special tokens (a copy of
``stac_st_tpu/data/text.py``).

Replicates ``add_special_tokens`` and the prompt-token semantics of the
reference (``stac-st/dataio_and_utils.py:40-67``): every target sequence is
prefixed with the ``[source_lang] [target_lang]`` token ids; ASR vs ST is
selected purely by that prompt (same-language ⇒ ASR).

Behavioral-fidelity notes (SURVEY.md §7.4):
* the reference's ``include_xt/include_turn=False`` branches call
  ``str.replace`` without assigning the result — a no-op. We replicate the
  *effective* behavior (tokens are never stripped here) and expose a working
  ``strip_special_tokens`` helper separately for callers that want it;
* the lang-token id is taken at index ``[1]`` of ``encode_as_ids("[xx]")``
  (after the dummy-prefix space piece), matching ``dataio_and_utils.py:54``;
  ``initialize_beam_search`` uses ``[-1]`` (``:240-241``) — identical result
  for user-defined symbols.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["add_special_tokens", "lang_token_id", "strip_special_tokens",
           "build_target_ids"]


def lang_token_id(tokenizer, lang: str) -> int:
    token = lang if "[" in lang else f"[{lang}]"
    return tokenizer.encode_as_ids(token)[-1]


def add_special_tokens(
    transcript_or_translation: str,
    source_lang: str,
    target_lang: str,
    tokenizer,
    include_xt: bool = False,
    include_turn: bool = False,
) -> Tuple[str, List[int]]:
    """Build the ground-truth token list: [src_lang, tgt_lang] + text tokens."""
    source_lang = source_lang if "[" in source_lang else f"[{source_lang}]"
    source_id = tokenizer.encode_as_ids(source_lang)[1]
    target_lang = target_lang if "[" in target_lang else f"[{target_lang}]"
    target_id = tokenizer.encode_as_ids(target_lang)[1]

    # reference quirk preserved: include_xt/include_turn=False is a no-op
    # (dataio_and_utils.py:59-62 discards the replace() result)

    tokens_list = tokenizer.encode_as_ids(transcript_or_translation)
    tokens_list = [source_id, target_id] + tokens_list
    return transcript_or_translation, tokens_list


def strip_special_tokens(text: str, tokens: Dict[str, int] | None = None) -> str:
    """Working removal of [turn]/[xt] markers from text (eval 'no_turn')."""
    for key in (tokens or {"[turn]": 7, "[xt]": 8}):
        text = text.replace(key, "").replace("  ", " ")
    return text.strip()


def build_target_ids(
    entry: Dict,
    tokenizer,
    bos_index: int = 1,
    eos_index: int = 2,
    include_xt: bool = True,
    include_turn: bool = True,
) -> Dict[str, List[int]]:
    """Per-manifest-entry token variants (reference text pipelines,
    ``train_multitask.py:519-596``): tokens (CTC), tokens_bos (decoder in),
    tokens_eos (decoder target)."""
    source_lang = entry["source_lang"]
    target_lang = entry["target_lang"]
    text = (
        entry.get("transcription")
        if source_lang == target_lang
        else entry.get("translation_0")
    )
    if text is None:
        text = entry.get("translation_0") or entry.get("transcription") or ""
    _, tokens = add_special_tokens(
        text, source_lang, target_lang, tokenizer,
        include_xt=include_xt, include_turn=include_turn,
    )
    return {
        "tokens": tokens,
        "tokens_bos": [bos_index] + tokens,
        "tokens_eos": tokens + [eos_index],
        "translation_or_transcription": text,
    }
