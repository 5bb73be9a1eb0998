"""Tiny synthetic corpus in the reference manifest schema, and a BPE
tokenizer trained on it (port of ``tests/fixtures.py``'s ``make_corpus``
and ``train_fixture_tokenizer``; the wavs and manifests are byte-equal to
the JAX package's for the same arguments). The quickstart and the
long-form protocol script train on it."""

import json
import os

import numpy as np

from ..data.audio import write_wav

WORDS_ES = ["hola", "como", "estas", "buenos", "dias", "gracias", "amigo",
            "claro", "que", "si"]
WORDS_EN = ["hello", "how", "are", "you", "good", "morning", "thanks",
            "friend", "sure", "yes"]


def make_corpus(root, n_utts=16, seconds=0.6, sample_rate=16000, seed=0,
                multi_turn_every=0, seconds_jitter=0.0):
    """Builds wavs + data-asr.json/data-st.json (+ joint manifest for the
    tokenizer). Returns (asr_json, st_json, joint_json).

    ``seconds_jitter`` > 0 varies utterance durations deterministically so
    padded batches exercise the length-mask paths."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    asr, st, joint = {}, {}, {}
    for i in range(n_utts):
        utt_seconds = seconds + seconds_jitter * (i % 4) / 4.0
        n = int(utt_seconds * sample_rate)
        t = np.arange(n) / sample_rate
        freq = 200 + 50 * (i % 8)
        wav = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        wav += 0.05 * rng.standard_normal(n).astype(np.float32)
        wav_path = os.path.join(root, "wav", f"utt{i:03d}.wav")
        write_wav(wav_path, wav, sample_rate)

        k = 2 + (i % 3)
        idx = rng.integers(0, len(WORDS_ES), k)
        es = " ".join(WORDS_ES[j] for j in idx)
        en = " ".join(WORDS_EN[j] for j in idx)
        if multi_turn_every and i % multi_turn_every == 0:
            es = es + " [turn] " + es
            en = en + " [turn] " + en
        base = {
            "wav": "{data_root}/wav/" + f"utt{i:03d}.wav",
            "duration": utt_seconds,
            "source_lang": "es",
            "target_lang": "en",
        }
        uid = f"conv{i % 4}-1-{i * 100}-{i * 100 + 60}"
        asr[uid] = dict(
            base, task="transcription", transcription=es, translation_0=es,
        )
        st[uid] = dict(
            base, task="translation", transcription=es, translation_0=en,
        )
        joint[uid] = {"transcription_and_translation": f"{es} {en}"}

    paths = []
    for name, data in (("data-asr", asr), ("data-st", st),
                       ("data-joint", joint)):
        p = os.path.join(root, f"{name}.json")
        with open(p, "w") as f:
            json.dump(data, f, indent=1)
        paths.append(p)
    return tuple(paths)


def train_fixture_tokenizer(root, joint_json, vocab=150):
    """(processor, model path) of a BPE tokenizer with the [es]/[en]/
    [turn]/[xt] symbols (unk 0, bos 1, eos 2)."""
    from ..tokenizer import SentencePiece

    tok = SentencePiece(
        model_dir=root,
        vocab_size=vocab,
        annotation_train=joint_json,
        annotation_read="transcription_and_translation",
        model_type="bpe",
        user_defined_symbols="[es],[en],[turn],[xt]",
        bos_id=1, eos_id=2, unk_id=0,
    )
    return tok.sp, tok.model_path
