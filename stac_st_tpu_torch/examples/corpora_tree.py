"""Seeded CommonVoice/CoVoST2 and MSLT trees, for the preparation scripts
(``prep/covost.py``, ``prep/mslt.py``, ``prep/mixing.py``) to run on where
the corpora are not at hand.

The speech is the port's learnable tone speech (:mod:`..data.synth`): a
clip renders a word sequence of a seeded lexicon, and its Spanish, English
and German texts are the same words in three syllable alphabets, so a
short training run can learn the mapping. Written under ``root``:

* ``cv/<lang>/clips/common_voice_<lang>_<n>.wav``: 16 kHz PCM16 clips of
  one speaker each, and the prepared CommonVoice manifests beside them
  (``cv/<lang>/{train,dev,test,all}.json``, the schema and the cleaning of
  the JAX package's ``prep/commonvoice.py``: bare clip keys, the CV
  cleaning chain, an empty ``translation_0``);
* ``covost/covost_v2.<src>_<tgt>.tsv``: a header row, then ``path``,
  ``sentence``, ``translation`` and ``split`` for two clips of three, one
  row whose clip is in no manifest (the preparation skips and counts it)
  and one whose translation has two words (the ≥3-words gate drops it);
* ``mslt/MSLT_Dev_EN/<id>.en.wav`` (the en→de dev subset) next to UTF-16
  ``<id>.T2.en.snt`` (the punctuated transcript) and ``<id>.T3.de.snt``
  (the translation); one transcript has one word (the MSLT gate drops
  it).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from ..data.audio import write_wav
from ..data.synth import (
    SR,
    Lexicon,
    _sample_sentence,
    _zipf_weights,
    build_lexicon,
    render_words,
)
from ..prep.cleaning import cv_clean_all

__all__ = ["make_corpora_tree", "render"]

CONS_DE = ["p", "t", "k", "b", "g", "sch", "w", "f", "z", "st", "r", "m"]
VOW_DE = ["a", "e", "ie", "ö", "ü"]
_PUNCT = (".", ".", "?", "!")
_SPLITS = ("dev", "test") + ("train",) * 6  # clip n -> _SPLITS[n % 8]
MSLT_SRC, MSLT_TGT, MSLT_SUBSET = "en", "de", "dev"
N_WORDS = 400  # the lexicon's size


def render(lex: Lexicon, i: int, lang: str) -> str:
    """Word ``i`` of the lexicon in the ``es``, ``en`` or ``de`` alphabet."""
    if lang == "de":
        return "".join(CONS_DE[c] + VOW_DE[v] for c, v in lex.words[i])
    return lex.es(i) if lang == "es" else lex.en(i)


def _sentence(lex, ids, lang, rng) -> str:
    """Raw text: capitals, a comma now and then, an end mark."""
    words = [render(lex, i, lang) for i in ids]
    words[0] = words[0].capitalize()
    if len(words) > 3 and rng.random() < 0.4:
        words[1] += ","
    return " ".join(words) + str(rng.choice(_PUNCT))


def _clip(lex, rng, zipf_w, speaker: int, lo: int = 3, hi: int = 7):
    """(word ids, 16 kHz audio with 0.2 s of silence either side)."""
    ids = _sample_sentence(rng, len(lex), zipf_w, lo=lo, hi=hi)
    pad = np.zeros(int(0.2 * SR), np.float32)
    wav = np.concatenate([pad, render_words(lex, ids, speaker, rng), pad])
    return ids, wav


def _write_json(path: str, data) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, ensure_ascii=False)
    return path


def _write_cv(root, lang, n_clips, lex, rng, zipf_w, speakers):
    """CV clips and the prepared manifests of one language; the clips'
    word ids by clip key."""
    clips = os.path.join(root, "cv", lang, "clips")
    os.makedirs(clips, exist_ok=True)
    by_split: Dict[str, Dict] = {s: {} for s in ("train", "dev", "test")}
    words: Dict[str, Tuple[int, ...]] = {}
    for n in range(n_clips):
        key = f"common_voice_{lang}_{19600000 + n}"
        speaker = int(rng.integers(0, 12))
        ids, wav = _clip(lex, rng, zipf_w, speaker)
        path = os.path.join(clips, key + ".wav")
        write_wav(path, wav, SR)
        speakers[path] = speaker
        words[key] = tuple(ids)
        by_split[_SPLITS[n % len(_SPLITS)]][key] = {
            "wav": path,
            "duration": len(wav) / SR,
            "task": "transcription",
            "source_lang": lang,
            "target_lang": lang,
            "transcription": cv_clean_all(_sentence(lex, ids, lang, rng),
                                          lang),
            "translation_0": "",
        }
    everything = {}
    for split, entries in by_split.items():
        _write_json(os.path.join(root, "cv", lang, f"{split}.json"),
                    entries)
        everything.update(entries)
    _write_json(os.path.join(root, "cv", lang, "all.json"), everything)
    return words


def _write_covost_tsv(root, src, tgt, words, lex, rng) -> str:
    """Two clips of three, then the missing clip and the 2-word row."""
    os.makedirs(os.path.join(root, "covost"), exist_ok=True)
    path = os.path.join(root, "covost", f"covost_v2.{src}_{tgt}.tsv")
    keys = sorted(words)
    rows = []
    for n, key in enumerate(keys):
        if n % 3 == 2:
            continue
        rows.append((key + ".mp3", _sentence(lex, words[key], src, rng),
                     _sentence(lex, words[key], tgt, rng),
                     _SPLITS[n % len(_SPLITS)]))
    short = keys[0]
    rows[0] = rows[0][:2] + (" ".join(
        render(lex, i, tgt) for i in words[short][:2]) + ".", rows[0][3])
    rows.append((f"common_voice_{src}_99999999.mp3", "Missing clip here.",
                 " ".join(render(lex, i, tgt) for i in range(4)) + ".",
                 "train"))
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(("path", "sentence", "translation", "split"))
        w.writerows(rows)
    return path


def _write_snt(path: str, text: str) -> None:
    with open(path, "w", encoding="utf-16") as f:
        f.write(text + "\n")


def _write_mslt(root, n_utts, lex, rng, zipf_w, speakers) -> str:
    src, tgt, subset = MSLT_SRC, MSLT_TGT, MSLT_SUBSET
    folder = os.path.join(root, "mslt", f"MSLT_{subset.capitalize()}_"
                          f"{src.upper()}")
    os.makedirs(folder, exist_ok=True)
    for n in range(n_utts):
        uid = f"{subset}_{src}_{tgt}_{n:04d}"
        speaker = int(rng.integers(0, 12))
        ids, wav = _clip(lex, rng, zipf_w, speaker,
                         *((1, 1) if n == 0 else (3, 7)))
        path = os.path.join(folder, f"{uid}.{src}.wav")
        write_wav(path, wav, SR)
        speakers[path] = speaker
        _write_snt(os.path.join(folder, f"{uid}.T2.{src}.snt"),
                   _sentence(lex, ids, src, rng))
        _write_snt(os.path.join(folder, f"{uid}.T3.{tgt}.snt"),
                   _sentence(lex, ids, tgt, rng))
    return os.path.join(root, "mslt")


def make_corpora_tree(
    root: str, n_clips: int = 24, n_mslt: int = 8, seed: int = 0,
    covost_pairs: Sequence[str] = ("es_en", "en_de"),
) -> Dict[str, object]:
    """Writes the trees under ``root``: ``n_clips`` CV clips for every
    source language of ``covost_pairs``, one TSV a pair, ``n_mslt``
    utterances of the MSLT en→de dev subset. Returns ``{"cv": the CV
    folder (``<lang>/<split>.json``), "cv_all": {lang: all.json}, "tsv":
    {pair: path}, "mslt": the MSLT folder, "speakers": {wav path:
    speaker}, "seconds": audio seconds written}``."""
    rng = np.random.default_rng(seed)
    lex = build_lexicon(N_WORDS, seed=seed)
    zipf_w = _zipf_weights(len(lex))
    speakers: Dict[str, int] = {}
    words = {}
    for src in dict.fromkeys(p.split("_")[0] for p in covost_pairs):
        words[src] = _write_cv(root, src, n_clips, lex, rng, zipf_w,
                               speakers)
    tsv = {}
    for pair in covost_pairs:
        src, tgt = pair.split("_")
        tsv[pair] = _write_covost_tsv(root, src, tgt, words[src], lex, rng)
    mslt = _write_mslt(root, n_mslt, lex, rng, zipf_w, speakers)
    seconds = 0.0
    for path in speakers:
        seconds += (os.path.getsize(path) - 44) / 2 / SR
    return {"cv": os.path.join(root, "cv"),
            "cv_all": {lang: os.path.join(root, "cv", lang, "all.json")
                       for lang in words},
            "tsv": tsv, "mslt": mslt, "speakers": speakers,
            "seconds": seconds}
