"""Deterministic, *learnable* synthetic speech corpus ("tone TTS"); a
port of ``stac_st_tpu/data/synth.py`` whose files are byte-equal to the
JAX package's for the same seeds and lexicon.

The audio deterministically encodes the word sequence, so a trained model
can generalize to held-out sentences: the flagship-shape quality protocol
(beam-vs-greedy BLEU/WER, long-form grid, speaker-change F1) runs on it at
the reference's published model scale (d256/4h/12+6L, vocab 5000 — the
reference's ``ablations/run_m_and_l_size.sh:72-99``).

Design
------
* A **lexicon** of pseudo-Spanish words built from a 12-consonant ×
  5-vowel syllable alphabet, with a deterministic word-level
  pseudo-English translation (a parallel syllable alphabet), so ST is a
  learnable word-by-word mapping and BLEU measures real generalization.
* Each syllable is rendered as a two-tone chord — f1 indexed by the
  consonant (geometric series 220→1960 Hz), f2 by the vowel
  (2400→4340 Hz) — clearly separable in the 80-mel fbank the model
  consumes.  Per-speaker pitch factors, amplitude jitter, and additive
  noise force the model to learn invariances instead of templates.
* **Multi-turn** utterances concatenate 2–3 single-speaker segments with
  ``[turn]`` markers (``[turn] [xt]`` when the segments overlap by more
  than 0.25 s), mirroring the reference's turn-concatenation prep
  (``fisher_callhome_prepare_turns.py:407-418``), with
  ``segments_start/duration/channel`` metadata in the manifest rows.
* Manifests use the reference JSON schema (``README.md:101-112`` of the
  reference) so the production dataset/loader/trainer consume them
  unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .audio import write_wav

SR = 16000

CONS_ES = ["b", "c", "d", "f", "g", "l", "m", "n", "p", "r", "s", "t"]
VOW_ES = ["a", "e", "i", "o", "u"]
CONS_EN = ["k", "w", "v", "z", "j", "h", "sh", "th", "br", "ch", "dr", "fl"]
VOW_EN = ["ee", "ay", "oo", "ih", "eh"]

# Harmonic-stack synthesis (speech-like, SpecAugment-robust): each
# syllable is a fundamental f0 (indexed by the CONSONANT, geometric
# spacing 18% >> the ±4% speaker pitch range) with 8 harmonics whose
# amplitude ENVELOPE is indexed by the VOWEL (formant-like profiles).
# Spreading every class's energy across many mel bins is what real
# speech does — and what the reference's SpecAugment assumes: a 30-bin
# freq mask removes part of a harmonic stack, not the whole class.
# (A first cut used single sine pairs; 2×30-bin masks then erased whole
# classes per utterance — label noise that plateaued flagship training
# at ACC≈0.3.)
_F0 = 220.0 * (1.18 ** np.arange(len(CONS_ES)))   # 220..1360 Hz
_N_HARM = 8
_K = np.arange(1, _N_HARM + 1, dtype=np.float32)
_VOWEL_ENV = np.stack([
    1.0 / _K,                                   # falling (a)
    np.ones_like(_K),                           # flat (e)
    np.exp(-0.5 * ((_K - 3.0) / 1.2) ** 2),     # mid peak (i)
    np.exp(-0.5 * ((_K - 6.5) / 1.5) ** 2),     # high peak (o)
    np.where(_K % 2 == 1, 1.0, 0.25),           # odd-harmonic (u)
]).astype(np.float32)
_VOWEL_ENV /= np.linalg.norm(_VOWEL_ENV, axis=1, keepdims=True)

SYLLABLE_SEC = 0.15
WORD_GAP_SEC = 0.06
EDGE_SEC = 0.012


@dataclass
class Lexicon:
    """Deterministic word list: ``words[i]`` is a tuple of (c, v) syllable
    index pairs; ``es(i)``/``en(i)`` render it in either alphabet."""

    words: List[Tuple[Tuple[int, int], ...]]

    def es(self, i: int) -> str:
        return "".join(CONS_ES[c] + VOW_ES[v] for c, v in self.words[i])

    def en(self, i: int) -> str:
        return "".join(CONS_EN[c] + VOW_EN[v] for c, v in self.words[i])

    def __len__(self) -> int:
        return len(self.words)


def build_lexicon(n_words: int = 2000, seed: int = 0) -> Lexicon:
    rng = np.random.default_rng(seed)
    seen, words = set(), []
    while len(words) < n_words:
        k = int(rng.integers(2, 6))  # 2..5 syllables
        w = tuple(
            (int(rng.integers(0, len(CONS_ES))),
             int(rng.integers(0, len(VOW_ES))))
            for _ in range(k)
        )
        if w not in seen:
            seen.add(w)
            words.append(w)
    return Lexicon(words)


def _render_syllable(c: int, v: int, pitch: float, rng) -> np.ndarray:
    n = int(SYLLABLE_SEC * SR)
    t = np.arange(n, dtype=np.float32) / SR
    f0 = _F0[c] * pitch
    weights = _VOWEL_ENV[v] * rng.uniform(
        0.8, 1.2, _N_HARM).astype(np.float32)
    # harmonics above Nyquist/mel range contribute aliasing, drop them
    keep = (f0 * _K) < 7600.0
    phases = rng.uniform(0.0, 2 * np.pi, _N_HARM).astype(np.float32)
    sig = np.zeros(n, np.float32)
    for k in range(_N_HARM):
        if keep[k]:
            sig += weights[k] * np.sin(
                2 * np.pi * f0 * _K[k] * t + phases[k])
    sig *= 0.3 / max(float(np.max(np.abs(sig))), 1e-6)
    edge = int(EDGE_SEC * SR)
    env = np.ones(n, np.float32)
    ramp = np.linspace(0.0, 1.0, edge, dtype=np.float32)
    env[:edge] = ramp
    env[-edge:] = ramp[::-1]
    return (sig * env).astype(np.float32)


def render_words(lex: Lexicon, word_ids: Sequence[int], speaker: int,
                 rng) -> np.ndarray:
    """One single-speaker segment: harmonic syllables with word gaps."""
    pitch = (0.96 + 0.016 * (speaker % 6)) * float(rng.uniform(0.99, 1.01))
    gap = np.zeros(int(WORD_GAP_SEC * SR), np.float32)
    parts: List[np.ndarray] = []
    for j, w in enumerate(word_ids):
        if j:
            parts.append(gap)
        for c, v in lex.words[w]:
            parts.append(_render_syllable(c, v, pitch, rng))
    wav = np.concatenate(parts)
    wav += (0.015 * rng.standard_normal(len(wav))).astype(np.float32)
    return wav


def _sample_sentence(rng, n_words_lex: int, zipf_w: np.ndarray,
                     lo: int = 3, hi: int = 9) -> List[int]:
    k = int(rng.integers(lo, hi + 1))
    return [int(i) for i in
            rng.choice(n_words_lex, size=k, p=zipf_w, replace=True)]


def _zipf_weights(n: int) -> np.ndarray:
    w = 1.0 / (np.arange(n) + 8.0) ** 0.8
    return w / w.sum()


@dataclass
class SynthUtt:
    wav: np.ndarray
    es: str
    en: str
    segments_start: List[float]     # within-utterance seconds
    segments_duration: List[float]
    segments_channel: List[int]     # speaker/channel id per segment
    nb_turns: int


def synth_utterance(lex: Lexicon, rng, zipf_w: np.ndarray,
                    multi_turn: bool = False, allow_xt: bool = True,
                    base_speaker: int = 0) -> SynthUtt:
    """Single- or multi-turn utterance with exact text + turn metadata."""
    n_segs = int(rng.integers(2, 4)) if multi_turn else 1
    seg_wavs, seg_texts_es, seg_texts_en, speakers = [], [], [], []
    for s in range(n_segs):
        spk = (base_speaker + s) % 12
        ids = _sample_sentence(rng, len(lex), zipf_w,
                               lo=3, hi=7 if multi_turn else 9)
        seg_wavs.append(render_words(lex, ids, spk, rng))
        seg_texts_es.append(" ".join(lex.es(i) for i in ids))
        seg_texts_en.append(" ".join(lex.en(i) for i in ids))
        speakers.append(spk)

    starts, durs = [0.0], [len(seg_wavs[0]) / SR]
    es_parts, en_parts = [seg_texts_es[0]], [seg_texts_en[0]]
    wav = seg_wavs[0]
    for s in range(1, n_segs):
        overlap = allow_xt and rng.uniform() < 0.3
        if overlap:
            ov = float(rng.uniform(0.3, 0.45))
            start = len(wav) / SR - ov
            n_ov = int(ov * SR)
            head, tail = seg_wavs[s][:n_ov], seg_wavs[s][n_ov:]
            wav = np.concatenate([wav[:-n_ov], wav[-n_ov:] + head, tail])
            marker = "[turn] [xt]"
        else:
            gap = float(rng.uniform(0.1, 0.25))
            start = len(wav) / SR + gap
            wav = np.concatenate(
                [wav, np.zeros(int(gap * SR), np.float32), seg_wavs[s]])
            marker = "[turn]"
        starts.append(start)
        durs.append(len(seg_wavs[s]) / SR)
        es_parts.extend([marker, seg_texts_es[s]])
        en_parts.extend([marker, seg_texts_en[s]])
    return SynthUtt(
        wav=wav, es=" ".join(es_parts), en=" ".join(en_parts),
        segments_start=starts, segments_duration=durs,
        segments_channel=[spk % 2 for spk in speakers],
        nb_turns=n_segs,
    )


def make_synth_corpus(
    root: str, n_utts: int = 1000, seed: int = 0,
    lexicon: Optional[Lexicon] = None, n_words: int = 2000,
    multi_turn_frac: float = 0.3, prefix: str = "s",
) -> Tuple[str, str, str]:
    """Writes wavs + ``data-asr.json``/``data-st.json``/``data-joint.json``
    (reference manifest schema).  Returns the three manifest paths.

    The ASR rows set ``target_lang == source_lang`` (transcription
    prompt), the ST rows keep es→en, matching the Fisher prep's mixture
    (``fisher_callhome_prepare.py``); the joint manifest carries
    ``transcription_and_translation`` for tokenizer training
    (``train_bpe_5k_special_prefix.xx_to_xx.yaml:25``)."""
    lex = lexicon or build_lexicon(n_words, seed=0)
    rng = np.random.default_rng(seed)
    zipf_w = _zipf_weights(len(lex))
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    asr, st, joint = {}, {}, {}
    for i in range(n_utts):
        u = synth_utterance(
            lex, rng, zipf_w,
            multi_turn=(rng.uniform() < multi_turn_frac),
            base_speaker=int(rng.integers(0, 12)),
        )
        name = f"{prefix}utt{i:06d}.wav"
        write_wav(os.path.join(root, "wav", name), u.wav, SR)
        dur = len(u.wav) / SR
        start_cs = i * 4000
        uid = (f"{prefix}conv{i % 64}-1-{start_cs}-"
               f"{start_cs + int(dur * 100)}")
        base = {
            "wav": "{data_root}/wav/" + name,
            "duration": round(dur, 4),
            "source_lang": "es",
            "target_lang": "en",
            "segments_start": " ".join(f"{s:.3f}" for s in u.segments_start),
            "segments_duration": " ".join(
                f"{d:.3f}" for d in u.segments_duration),
            "segments_channel": " ".join(
                str(c) for c in u.segments_channel),
            "nb_turns": u.nb_turns,
        }
        asr[uid] = dict(base, task="transcription", target_lang="es",
                        transcription=u.es, translation_0=u.es)
        st[uid] = dict(base, task="translation",
                       transcription=u.es, translation_0=u.en)
        joint[uid] = {"transcription_and_translation": f"{u.es} {u.en}"}

    paths = []
    for name, data in (("data-asr", asr), ("data-st", st),
                       ("data-joint", joint)):
        p = os.path.join(root, f"{name}.json")
        with open(p, "w") as f:
            json.dump(data, f, indent=1)
        paths.append(p)
    return tuple(paths)


def write_mixed_manifest(asr_json: str, st_json: str, out_path: str) -> str:
    """ASR+ST training mixture (the reference's jq-merge cascade,
    ``run_data_preparation_turns.sh:70-92``): both prompt types seen."""
    mixed = {}
    for tag, path in (("asr", asr_json), ("st", st_json)):
        with open(path) as f:
            for uid, entry in json.load(f).items():
                mixed[f"{uid}-{tag}"] = entry
    with open(out_path, "w") as f:
        json.dump(mixed, f, indent=1)
    return out_path


def make_synth_conversations(
    root: str, lex: Lexicon, n_convs: int = 4, utts_per_conv: int = 16,
    seed: int = 100, gap_s: float = 0.6, multi_turn_frac: float = 0.4,
) -> Tuple[List[Dict], Dict, str]:
    """Long-form conversations for the L7 protocol: each conversation is
    one wav (utterances + silence gaps) plus a reference-schema manifest
    of its ground-truth utterances (the format
    ``evaluations/vad_shas/run_full_protocol.py`` scores against)."""
    rng = np.random.default_rng(seed)
    zipf_w = _zipf_weights(len(lex))
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    convs, manifest = [], {}
    for c in range(n_convs):
        wav_parts = [np.zeros(int(gap_s * SR), np.float32)]
        t = gap_s
        ref_uids = []
        for k in range(utts_per_conv):
            u = synth_utterance(
                lex, rng, zipf_w,
                multi_turn=(rng.uniform() < multi_turn_frac),
                base_speaker=int(rng.integers(0, 12)),
            )
            dur = len(u.wav) / SR
            name = f"lconv{c:02d}_u{k:03d}.wav"
            path = os.path.join(root, "wav", name)
            write_wav(path, u.wav, SR)
            start_cs = int(round(t * 100))
            uid = f"lconv{c}-0-{start_cs:06d}-{start_cs + int(dur * 100):06d}"
            manifest[uid] = {
                "wav": path, "duration": round(dur, 4),
                "transcription": u.es, "translation_0": u.en,
                "offset": t,
                "segments_start": " ".join(
                    f"{s:.3f}" for s in u.segments_start),
                "segments_channel": " ".join(
                    str(ch) for ch in u.segments_channel),
            }
            ref_uids.append(uid)
            wav_parts.append(u.wav)
            wav_parts.append(np.zeros(int(gap_s * SR), np.float32))
            t += dur + gap_s
        conv_wav = np.concatenate(wav_parts)
        write_wav(os.path.join(root, "wav", f"lconv{c:02d}.wav"),
                  conv_wav, SR)
        convs.append({"uri": f"lconv{c}", "wav": conv_wav,
                      "ref_uids": ref_uids})
    man_path = os.path.join(root, "data-longform.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=1)
    return convs, manifest, man_path
