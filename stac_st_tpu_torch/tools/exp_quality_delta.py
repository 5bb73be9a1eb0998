"""The trained fixture model of the greedy-vs-beam quality experiment
(port of ``tools/exp_quality_delta.py``'s ``train_fixture`` and
``_load_split``, the parts the long-form protocol script uses).

``train_fixture`` trains a tiny multitask model (d48, 4 heads, 2 + 2
layers, vocab 200, CNN (16, 16)) on the fixture corpus's ASR+ST mixture
with the port's ``STTrainer``, one train step a batch, the CMVN update on
in the first two epochs; ``_load_split`` writes a fixture split and reads
its wavs and references back.
"""

import json
import os
import wave

import numpy as np

from ..examples.fixtures import make_corpus, train_fixture_tokenizer

VOCAB = 200

__all__ = ["train_fixture", "_load_split", "VOCAB"]


def train_fixture(workdir, epochs, n_utts, device=None):
    """Returns dict(sp, cnn, transformer, seq_lin, ctc_lin, cmvn): the
    tokenizer, the trained modules (holding their weights) and the CMVN
    state. Runs on cuda unless ``device`` says otherwise."""
    from ..data.dataset import SpeechDataset
    from ..data.loader import BatchLoader
    from ..decoding.beam_search import MultiTaskBeamSearch
    from ..models import ConvolutionFrontEnd, LinearHead, TransformerMultiTask
    from ..ops.cmvn import InputNormalization
    from ..ops.fbank import Fbank
    from ..training.optim import AdamW
    from ..training.schedulers import WarmCoolDecayLRSchedule
    from ..training.trainer import STTrainer
    from ..utils.metrics import AccuracyStats, BLEUStats, ErrorRateStats

    asr_json, st_json, joint_json = make_corpus(
        workdir, n_utts=n_utts, seconds=0.5, seconds_jitter=0.4, seed=0,
        multi_turn_every=3,
    )
    sp, _ = train_fixture_tokenizer(workdir, joint_json, vocab=VOCAB)

    # the reference trains on the ASR+ST MIXTURE (both prompts seen)
    mixed = {}
    for tag, path in (("asr", asr_json), ("st", st_json)):
        with open(path) as f:
            for uid, entry in json.load(f).items():
                if tag == "asr":
                    # ASR rows prompt [src][src], as the Fisher prep sets
                    # target_lang == source_lang for transcription rows
                    entry = dict(entry, target_lang=entry["source_lang"])
                mixed[f"{uid}-{tag}"] = entry
    mixed_json = os.path.join(workdir, "data-mixed.json")
    with open(mixed_json, "w") as f:
        json.dump(mixed, f)

    cnn = ConvolutionFrontEnd(n_mels=80, out_channels=(16, 16))
    transformer = TransformerMultiTask(
        VOCAB, 20 * 16, d_model=48, nhead=4, num_encoder_layers=2,
        num_decoder_layers=2, d_ffn=96, dropout=0.1, normalize_before=True,
    )
    seq_lin = LinearHead(48, VOCAB)
    ctc_lin = LinearHead(48, VOCAB)
    searcher = MultiTaskBeamSearch(
        [transformer, seq_lin, ctc_lin], bos_index=1, eos_index=2,
        blank_index=0, beam_size=3,
    )
    hparams = {
        "compute_features": Fbank(),
        "ctc_weight": 0.3, "label_smoothing": 0.1,
        "loss_reduction": "batchmean", "pad_index": 0, "blank_index": 0,
        "turn": sp.piece_to_id("[turn]"), "xt": sp.piece_to_id("[xt]"),
        "grad_accumulation_factor": 1, "max_grad_norm": 5.0,
        "lr_adam": 3e-3, "seed": 0, "optimizer_step_limit": 10_000,
        "valid_search_interval": 10_000,
        "lr_scheduler": WarmCoolDecayLRSchedule(3e-3, 10, 10, 4000,
                                                decay_every=400),
        "Adam": AdamW(lr=3e-3),
        "tokenizer": sp,
        "valid_search": searcher, "test_search": searcher,
        "acc_computer": AccuracyStats, "bleu_computer": BLEUStats,
        "error_rate_computer": ErrorRateStats,
    }
    modules = {"CNN": cnn, "Transformer": transformer, "seq_lin": seq_lin,
               "ctc_lin": ctc_lin, "normalize": InputNormalization()}
    dataset = SpeechDataset(mixed_json, tokenizer=sp,
                            replacements={"data_root": workdir})
    loader = BatchLoader(dataset, batch_size=8, token_pad_multiple=16)
    trainer = STTrainer(modules=modules, opt_class=hparams["Adam"],
                        hparams=hparams, run_opts={}, device=device)
    trainer.ensure_state()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        losses = []
        for batch in loader:
            dev = trainer._device_batch(batch)
            trainer.state, m = trainer.train_step(
                trainer.state, dev, trainer.next_seed(),
                update_cmvn=(epoch < 2))
            losses.append(float(m["loss"]))
        if epoch % 10 == 0 or epoch == epochs - 1:
            print(f"# epoch {epoch}: loss {np.mean(losses):.3f}",
                  flush=True)
    return dict(sp=sp, cnn=cnn, transformer=transformer, seq_lin=seq_lin,
                ctc_lin=ctc_lin, cmvn=trainer.state.cmvn)


def _load_split(workdir, n_utts, seed):
    """Wavs + (es, en) references of a fixture split written to
    ``<workdir>/split_<seed>``."""
    d = os.path.join(workdir, f"split_{seed}")
    os.makedirs(d, exist_ok=True)
    _, st_json, _ = make_corpus(d, n_utts=n_utts, seconds=0.5,
                                seconds_jitter=0.4, seed=seed,
                                multi_turn_every=3)
    with open(st_json) as f:
        meta = json.load(f)
    wavs, refs_es, refs_en = [], [], []
    for utt in sorted(meta):
        path = meta[utt]["wav"].replace("{data_root}", d)
        with wave.open(path, "rb") as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        wavs.append(pcm.astype(np.float32) / 32768.0)
        refs_es.append(meta[utt]["transcription"])
        refs_en.append(meta[utt]["translation_0"])
    return wavs, refs_es, refs_en
