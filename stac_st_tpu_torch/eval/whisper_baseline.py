"""Whisper baseline runner (HF transformers) over the frozen manifests.

A port of ``stac_st_tpu/eval/whisper_baseline.py``: the same cleanup,
references and scores, with the model and its inputs on ``device``
(``cuda`` unless the caller passes ``device="cpu"``). ``transformers`` is
imported inside the function, so importing this module needs only torch.

Re-owns ``evaluations/whisper/eval_whisper.py``: decode each manifest
utterance with a Whisper checkpoint (tiny→medium), forcing the (language,
task) decoder prompt, the reference's exact hypothesis cleanup chain
(``clean_transcript_translation``, :53-77 — normalize_punctuation →
clean_transcription → Moses normalize → de-punctuate), 4-ref BLEU with
``[turn]``/``[xt]`` stripping + Moses detokenization of references
(``extract_reference:360-391``), WER with the >125 % outlier skip
(:495-498), and per-conversation reporting.

Nothing is downloaded, so the checkpoint must be a local path
(``model_path``); the runner raises when it is absent. Whisper here is a
*baseline*, not a framework component — it runs on the CPU or the GPU via
torch, exactly as in the reference.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.audio import read_audio
from ..device import resolve_device
from ..prep.cleaning import (
    moses_detokenize,
    remove_special_turn_tokens,
    whisper_clean_output,
)
from ..utils.metrics import BLEUStats, ErrorRateStats

logger = logging.getLogger(__name__)

__all__ = ["run_whisper_baseline", "build_tiny_whisper"]

WER_OUTLIER_PCT = 125.0


def run_whisper_baseline(
    manifest_path: str,
    model_path: str,
    task: str = "transcribe",       # transcribe | translate
    language: str = "es",
    out_dir: Optional[str] = None,
    max_utterances: Optional[int] = None,
    device=None,
) -> Dict[str, float]:
    """Returns {"WER": ...} or {"BLEU": ...} summary for the manifest."""
    try:
        from transformers import WhisperForConditionalGeneration, WhisperProcessor
    except ImportError as exc:  # pragma: no cover
        raise RuntimeError(f"transformers/torch unavailable: {exc}")
    dev = resolve_device(device)
    if not os.path.isdir(model_path) and not os.path.isfile(model_path):
        raise FileNotFoundError(
            f"whisper checkpoint not found at {model_path!r}; nothing is "
            "downloaded here — put the model on disk and point model_path "
            "at it"
        )

    processor = WhisperProcessor.from_pretrained(model_path)
    model = WhisperForConditionalGeneration.from_pretrained(model_path)
    model.to(dev).eval()
    forced_ids = processor.get_decoder_prompt_ids(
        language=language, task=task
    )

    with open(manifest_path) as f:
        data = json.load(f)

    bleu = BLEUStats()
    wer = ErrorRateStats()
    rows: List[List[str]] = []
    n_ref_streams = None
    for i, (uid, entry) in enumerate(data.items()):
        if max_utterances is not None and i >= max_utterances:
            break
        wavs = entry["wav"].split()
        sig = np.concatenate(
            [read_audio(w, sample_rate=16000)[0] for w in wavs]
        )
        inputs = processor(
            sig, sampling_rate=16000, return_tensors="pt"
        ).input_features.to(dev)
        with torch.no_grad():
            try:
                # reference API (eval_whisper.py:466-468)
                generated = model.generate(
                    inputs, forced_decoder_ids=forced_ids,
                    max_new_tokens=256,
                )
            except (ValueError, TypeError):
                # transformers ≥4.50 removed forced_decoder_ids from
                # generate(); pass the same prompt as decoder_input_ids
                prompt = torch.tensor(
                    [[model.config.decoder_start_token_id]
                     + [tid for _, tid in forced_ids]], device=dev
                )
                generated = model.generate(
                    inputs,
                    decoder_input_ids=prompt.repeat(inputs.shape[0], 1),
                    max_new_tokens=256,
                )
        # reference hypothesis cleanup chain (eval_whisper.py:53-77,473)
        hyp = whisper_clean_output(processor.batch_decode(
            generated, skip_special_tokens=True
        )[0])
        if task == "translate":
            # 4-ref Fisher dev/test or single-ref (extract_reference)
            keys = [f"translation_{n}" for n in range(4)
                    if f"translation_{n}" in entry] or ["translation_0"]
            refs = [
                moses_detokenize(
                    remove_special_turn_tokens(entry.get(k, "")), "en"
                )
                for k in keys
            ]
            if n_ref_streams is None:
                n_ref_streams = len(refs)
            refs = (refs + [""] * n_ref_streams)[:n_ref_streams]
            rows.append([uid, refs[0], hyp])
            bleu.append([uid], [hyp], [[r] for r in refs])
        else:
            ref = moses_detokenize(
                remove_special_turn_tokens(entry.get("transcription", "")),
                entry.get("source_lang", "es"),
            )
            rows.append([uid, ref, hyp])
            detail_wer = ErrorRateStats()
            detail_wer.append([uid], [hyp.split()], [ref.split()])
            if detail_wer.summarize("error_rate") > WER_OUTLIER_PCT:
                logger.warning("skipping outlier %s (WER > %.0f%%)",
                               uid, WER_OUTLIER_PCT)
                continue
            wer.append([uid], [hyp.split()], [ref.split()])

    summary: Dict[str, float] = {}
    if task == "translate":
        summary["BLEU"] = bleu.summarize("BLEU")
    else:
        summary["WER"] = wer.summarize("error_rate")

    # per-conversation breakdown (ids share the prefix before the first
    # '-' — reference eval_whisper reports per conversation, :439-516)
    per_conv: Dict[str, Dict[str, list]] = {}
    for uid, ref, hyp in rows:
        conv = uid.split("-")[0]
        per_conv.setdefault(conv, {"refs": [], "hyps": [], "ids": []})
        per_conv[conv]["refs"].append(ref)
        per_conv[conv]["hyps"].append(hyp)
        per_conv[conv]["ids"].append(uid)
    conv_scores: Dict[str, float] = {}
    for conv, group in per_conv.items():
        if task == "translate":
            m = BLEUStats()
            m.append(group["ids"], group["hyps"], [group["refs"]])
            conv_scores[conv] = m.summarize("BLEU")
        else:
            m = ErrorRateStats()
            m.append(group["ids"], [h.split() for h in group["hyps"]],
                     [r.split() for r in group["refs"]])
            conv_scores[conv] = m.summarize("error_rate")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(manifest_path))[0]
        with open(os.path.join(out_dir, f"whisper_{task}_{base}.json"),
                  "w") as f:
            json.dump({"summary": summary, "per_conversation": conv_scores,
                       "outputs": rows}, f, indent=2, ensure_ascii=False)
    summary["per_conversation"] = conv_scores
    return summary


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table (Whisper's byte-level BPE
    alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def build_tiny_whisper(out_dir: str, seed: int = 0) -> str:
    """A tiny random Whisper checkpoint and processor written to
    ``out_dir`` (d32, 2 + 2 layers, a byte-level vocabulary with no merges
    and the task/language special tokens), built locally so the baseline
    runs without a download; the model's weights come from
    ``torch.manual_seed(seed)``."""
    from transformers import (
        WhisperConfig,
        WhisperFeatureExtractor,
        WhisperForConditionalGeneration,
        WhisperTokenizer,
    )

    os.makedirs(out_dir, exist_ok=True)
    vocab = {c: i for i, c in enumerate(_bytes_to_unicode().values())}
    vocab["<|endoftext|>"] = len(vocab)
    vocab_file = os.path.join(out_dir, "vocab.json")
    merges_file = os.path.join(out_dir, "merges.txt")
    with open(vocab_file, "w") as f:
        json.dump(vocab, f)
    with open(merges_file, "w") as f:
        f.write("#version: 0.2\n")
    tok = WhisperTokenizer(vocab_file, merges_file)
    tok.add_special_tokens({
        "additional_special_tokens": ["<|startoftranscript|>"]
        + [f"<|{lang}|>" for lang in ("en", "es", "de", "fr")]
        + ["<|translate|>", "<|transcribe|>", "<|notimestamps|>"],
    })
    tok.save_pretrained(out_dir)
    WhisperFeatureExtractor(feature_size=80).save_pretrained(out_dir)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        cfg = WhisperConfig(
            vocab_size=len(tok), d_model=32,
            encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=64, decoder_ffn_dim=64,
            num_mel_bins=80, max_source_positions=1500,
            max_target_positions=448,
            pad_token_id=tok.pad_token_id or vocab["<|endoftext|>"],
            bos_token_id=vocab["<|endoftext|>"],
            eos_token_id=vocab["<|endoftext|>"],
            decoder_start_token_id=tok.convert_tokens_to_ids(
                "<|startoftranscript|>"),
            suppress_tokens=[], begin_suppress_tokens=[],
        )
        model = WhisperForConditionalGeneration(cfg)
    model.generation_config.suppress_tokens = None
    model.generation_config.begin_suppress_tokens = None
    model.generation_config.forced_decoder_ids = None
    model.generation_config.max_length = 24
    model.save_pretrained(out_dir)
    return out_dir
