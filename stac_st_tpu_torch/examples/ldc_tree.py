"""A seeded raw Fisher/CALLHOME tree in the LDC layouts, for the
preparation scripts (``prep/fisher.py``, ``prep/callhome.py``) to run on
where the LDC corpora are not at hand.

Each conversation is a two-channel 8 kHz µ-law NIST SPHERE file (one
speaker a channel, tones in noise while that speaker talks) with its
transcript: Fisher's tab-separated ``.tdf`` (three header lines) or
CALLHOME's ISO-8859-1 ``start end A: text`` lines. The transcripts carry
the markup the cleaners strip (``<laugh>``, ``[noise]``, ``((...))``,
inverted marks, capitals, punctuation). Turns alternate between the
speakers most of the time and overlap now and then by up to 0.8 s, so the
multi-turn builder writes both ``[turn]`` and ``[turn] [xt]``. The
``fisher-callhome-corpus`` side holds the mapping files (one transcript
row an utterance, now and then two rows joined as ``i_j``) and the
English references: one for train splits, four for Fisher's dev splits.
Every split the preparation scripts read has its files, empty where no
conversation went to it.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

__all__ = ["ulaw_encode", "write_sphere_ulaw", "make_ldc_tree"]

# every split the preparation scripts read; Fisher's dev splits carry
# four English references
_FOUR_REFS = ("fisher_dev", "fisher_dev2", "fisher_test")
_ALL_SPLITS = _FOUR_REFS + ("fisher_train", "callhome_devtest",
                            "callhome_evltest", "callhome_train")

_WORDS_ES = ("hola", "como", "estas", "bueno", "claro", "que", "si", "no",
             "gracias", "amigo", "mañana", "también", "pues", "entonces",
             "trabajo", "familia", "ciudad", "música", "año", "después")
_WORDS_EN = ("hello", "how", "are", "you", "well", "sure", "that", "yes",
             "no", "thanks", "friend", "tomorrow", "also", "so", "then",
             "work", "family", "city", "music", "year")
_MARKUP_ES = ("<laugh>", "[noise]", "((bueno))", "¿verdad?", "¡Sí!", "ÁNDALE",
              "<breath/>", "eh,", "mm.")
_MARKUP_EN = ("Well,", "you're", "\"right\"", "OK.", "Really?", "it's",
              "(laughs)", "U.S.", "well...")


def ulaw_encode(x: np.ndarray) -> np.ndarray:
    """Float samples in [-1, 1] -> G.711 µ-law bytes (uint8)."""
    pcm = np.clip(np.round(np.asarray(x, np.float64) * 32767), -32767, 32767)
    pcm = pcm.astype(np.int32)
    sign = np.where(pcm < 0, 0x80, 0)
    mag = np.minimum(np.abs(pcm) + 0x84, 0x7FFF)
    exponent = np.floor(np.log2(np.maximum(mag, 1))).astype(np.int32) - 7
    exponent = np.clip(exponent, 0, 7)
    mantissa = (mag >> (exponent + 3)) & 0x0F
    return (~(sign | (exponent << 4) | mantissa) & 0xFF).astype(np.uint8)


def write_sphere_ulaw(path: str, samples: np.ndarray, rate: int = 8000
                      ) -> None:
    """NIST SPHERE, µ-law, samples (n, channels) interleaved."""
    samples = np.asarray(samples)
    channels = 1 if samples.ndim == 1 else samples.shape[1]
    header = (
        "NIST_1A\n   1024\n"
        f"sample_rate -i {rate}\n"
        f"channel_count -i {channels}\n"
        "sample_n_bytes -i 1\n"
        "sample_coding -s4 ulaw\n"
        "end_head\n"
    ).encode()
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)))
        f.write(ulaw_encode(samples.reshape(-1)).tobytes())


def _sentence(rng, words, markup, n) -> str:
    out = [str(w) for w in rng.choice(words, n)]
    if rng.random() < 0.5:
        out.insert(int(rng.integers(0, n + 1)), str(rng.choice(markup)))
    if rng.random() < 0.3:
        out[0] = out[0].capitalize()
    return " ".join(out)


def _conversation(rng, seconds: float, rate: int):
    """(audio (n, 2) float32, rows [(channel, start_s, end_s)])."""
    rows, t, channel = [], 0.5, int(rng.integers(0, 2))
    while True:
        dur = float(rng.uniform(1.5, 6.0))
        if t + dur > seconds - 0.5:
            break
        rows.append((channel, round(t, 2), round(t + dur, 2)))
        switch = rng.random() < 0.7
        channel = 1 - channel if switch else channel
        gap = float(rng.uniform(-0.8, 0.6)) if switch else float(
            rng.uniform(0.1, 0.6))
        t = t + dur + gap
    n = int(seconds * rate)
    audio = 0.01 * rng.standard_normal((n, 2))
    freqs = rng.uniform(150, 400, 2)
    for ch, start, end in rows:
        lo, hi = int(start * rate), int(end * rate)
        tt = np.arange(hi - lo) / rate
        audio[lo:hi, ch] += 0.3 * np.sin(2 * np.pi * freqs[ch] * tt) * (
            1 + 0.5 * np.sin(2 * np.pi * 3 * tt))
    return np.clip(audio, -1, 1).astype(np.float32), rows


def make_ldc_tree(root: str, n_fisher: int = 2, n_callhome: int = 2,
                  seconds: float = 40.0, seed: int = 0,
                  fisher_splits: Sequence[str] = ("train", "dev"),
                  callhome_splits: Sequence[str] = ("train", "devtest"),
                  rate: int = 8000) -> Dict[str, object]:
    """Writes the tree under ``root``; conversation i of a corpus goes to
    split ``splits[i % len(splits)]``. Returns ``{"raw": root, "corpus":
    the fisher-callhome-corpus folder, "utterances": mapping lines
    written, "seconds": audio seconds written}``."""
    rng = np.random.default_rng(seed)
    corpus = os.path.join(root, "fisher-callhome-corpus")
    dirs = {
        "fisher": (os.path.join(root, "LDC2010T04", "fisher_spa", "data",
                                "speech"),
                   os.path.join(root, "LDC2010T04", "fisher_spa_tr", "data",
                                "transcripts")),
        "callhome": (os.path.join(root, "LDC96S35", "callhome", "spanish",
                                  "speech"),
                     os.path.join(root, "LDC96T17",
                                  "callhome_spanish_trans_970711",
                                  "transcrp")),
    }
    for d in [*dirs["fisher"], *dirs["callhome"],
              os.path.join(corpus, "mapping"),
              os.path.join(corpus, "corpus", "ldc")]:
        os.makedirs(d, exist_ok=True)
    mapping = {split: [] for split in _ALL_SPLITS}
    refs = {split: [[] for _ in range(4 if split in _FOUR_REFS else 1)]
            for split in _ALL_SPLITS}
    n_utts = 0
    for corpus_name, count, splits in (("fisher", n_fisher, fisher_splits),
                                       ("callhome", n_callhome,
                                        callhome_splits)):
        speech, trans = dirs[corpus_name]
        for i in range(count):
            split = f"{corpus_name}_{splits[i % len(splits)]}"
            rec = (f"2005{i:04d}_{seed:03d}_fsp" if corpus_name == "fisher"
                   else f"sp{i:04d}")
            audio, rows = _conversation(rng, seconds, rate)
            write_sphere_ulaw(os.path.join(speech, f"{rec}.sph"), audio, rate)
            texts = [_sentence(rng, _WORDS_ES, _MARKUP_ES,
                               int(rng.integers(2, 9))) for _ in rows]
            if corpus_name == "fisher":
                lines = ["file;unicode\tchannel\tstart\tend\tspeaker\t"
                         "speakerType\tspeakerDialect\ttranscript\tsection\t"
                         "turn\tsegment\n", ";;MM\n", ";;MM\n"]
                lines += [f"{rec}.sph\t{ch}\t{s:.2f}\t{e:.2f}\t"
                          f"{rec}_{'AB'[ch]}\tnative\tcaribbean\t{text}\t0\t"
                          f"{k}\t{k}\n"
                          for k, ((ch, s, e), text) in enumerate(
                              zip(rows, texts))]
                with open(os.path.join(trans, f"{rec}.tdf"), "w",
                          encoding="utf-8") as f:
                    f.writelines(lines)
            else:
                with open(os.path.join(trans, f"{rec}.txt"), "w",
                          encoding="ISO-8859-1") as f:
                    f.write(f"# {rec}\n\n")
                    f.writelines(f"{s:.2f} {e:.2f} {'AB'[ch]}: {text}\n\n"
                                 for (ch, s, e), text in zip(rows, texts))
            k = 0
            while k < len(rows):
                take = 2 if rng.random() < 0.15 and k + 1 < len(rows) else 1
                ch, start, _ = rows[k]
                end = rows[k + take - 1][2]
                idx = "_".join(str(j + 1) for j in range(k, k + take))
                uid = (f"{rec}-{'AB'[ch]}-{int(start * 100):06d}-"
                       f"{int(end * 100):06d}")
                mapping[split].append(f"{uid} {idx}\n")
                for r in refs[split]:
                    r.append(_sentence(rng, _WORDS_EN, _MARKUP_EN,
                                       int(rng.integers(2, 9))) + "\n")
                k += take
                n_utts += 1
    for split, lines in mapping.items():
        with open(os.path.join(corpus, "mapping", split), "w") as f:
            f.writelines(lines)
        n_refs = len(refs[split])
        for j, lines_j in enumerate(refs[split]):
            suffix = f".{j}" if n_refs > 1 else ""
            with open(os.path.join(corpus, "corpus", "ldc",
                                   f"{split}.en{suffix}"), "w",
                      encoding="utf-8") as f:
                f.writelines(lines_j)
    return {"raw": root, "corpus": corpus, "utterances": n_utts,
            "seconds": seconds * (n_fisher + n_callhome)}
