"""End-to-end quickstart on synthetic data with the port (port of
``examples/quickstart.py``: the same stages at the same tiny size).

Walks the whole stack exactly like a real experiment, just tiny:

  1. build a synthetic Fisher-style corpus (wavs + JSON manifests);
  2. train a BPE tokenizer with the [es]/[en]/[turn]/[xt] symbols;
  3. train a small multitask ASR+ST model for a few epochs;
  4. decode with the prompted beam search (same model, ASR and ST);
  5. extract speaker-turn RTTM events from the CTC head;
  6. serve the model through STEngine (then a whole conversation through
     ``long_form`` and requests through the continuous slot loop).

Runs on the card; ``--cpu`` (or ``--device cpu``) on the CPU, in about a
minute.

    python -m stac_st_tpu_torch.examples.quickstart [--workdir DIR] [--cpu]
"""

import argparse
import os
import tempfile


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "stac_quickstart"))
    parser.add_argument("--epochs", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--cpu", action="store_true",
                        help="the CPU (the JAX quickstart's flag)")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import numpy as np

    from ..data.dataset import SpeechDataset
    from ..data.loader import BatchLoader
    from ..decoding.beam_search import MultiTaskBeamSearch
    from ..models import ConvolutionFrontEnd, LinearHead, TransformerMultiTask
    from ..ops.cmvn import InputNormalization
    from ..ops.fbank import Fbank
    from ..serving import STEngine
    from ..training.checkpoint import Checkpointer
    from ..training.optim import AdamW
    from ..training.schedulers import WarmCoolDecayLRSchedule
    from ..training.trainer import STTrainer
    from ..utils.metrics import AccuracyStats, BLEUStats, ErrorRateStats
    from .fixtures import make_corpus, train_fixture_tokenizer

    os.makedirs(args.workdir, exist_ok=True)
    print(f"== 1. synthetic corpus -> {args.workdir}")
    asr_json, st_json, joint_json = make_corpus(
        args.workdir, n_utts=16, seconds=0.6, multi_turn_every=4
    )

    print("== 2. BPE tokenizer (unk=0 bos=1 eos=2, [es]=3 [en]=4 ...)")
    sp, model_path = train_fixture_tokenizer(args.workdir, joint_json,
                                             vocab=200)
    print(f"   [turn] id = {sp.piece_to_id('[turn]')}")

    print(f"== 3. train a tiny multitask model on {device}")
    cnn = ConvolutionFrontEnd(n_mels=80, out_channels=(16, 16))
    transformer = TransformerMultiTask(
        200, 20 * 16, d_model=48, nhead=4, num_encoder_layers=2,
        num_decoder_layers=2, d_ffn=96, dropout=0.1, normalize_before=True,
    )
    seq_lin = LinearHead(48, 200)
    ctc_lin = LinearHead(48, 200)
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
        "valid_search_interval": 1000,
        "lr_scheduler": WarmCoolDecayLRSchedule(3e-3, 10, 10, 2000,
                                                decay_every=200),
        "Adam": AdamW(lr=3e-3),
        "tokenizer": sp,
        "valid_search": searcher, "test_search": searcher,
        "acc_computer": AccuracyStats, "bleu_computer": BLEUStats,
        "error_rate_computer": ErrorRateStats,
    }
    modules = {"CNN": cnn, "Transformer": transformer, "seq_lin": seq_lin,
               "ctc_lin": ctc_lin, "normalize": InputNormalization()}
    dataset = SpeechDataset(st_json, tokenizer=sp,
                            replacements={"data_root": args.workdir})
    loader = BatchLoader(dataset, batch_size=4, token_pad_multiple=16)
    trainer = STTrainer(
        modules=modules, opt_class=hparams["Adam"], hparams=hparams,
        run_opts={}, checkpointer=Checkpointer(
            os.path.join(args.workdir, "save")
        ), device=device,
    )
    trainer.ensure_state()
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        losses = []
        for batch in loader:
            dev = trainer._device_batch(batch)
            trainer.state, m = trainer.train_step(
                trainer.state, dev, trainer.next_seed(),
                update_cmvn=(epoch < 2))
            losses.append(float(m["loss"]))
        print(f"   epoch {epoch}: loss {np.mean(losses):.3f}")

    print("== 4. prompted decode (same model, task chosen by prompt)")
    batch = next(iter(loader))
    dev = trainer._device_batch(batch)
    p_ctc, _, enc_out = trainer.eval_forward(
        trainer.state.params, trainer.state.cmvn, dev
    )
    n = len(batch.id)
    for task, tgt in (("ASR", "[es]"), ("ST ", "[en]")):
        searcher.set_decoder_prefix_tokens(
            sp.piece_to_id("[es]"), sp.piece_to_id(tgt)
        )
        hyps, _ = searcher(enc_out, dev["sig_len"])
        print(f"   {task}: {sp.decode_ids(hyps[0])!r}")

    print("== 5. speaker-turn events from the CTC head")
    from ..utils.rttm import extract_turn_events

    am = p_ctc.argmax(-1).cpu().numpy()[:n]
    events = extract_turn_events(
        batch.id, am,
        {"turn": sp.piece_to_id("[turn]"), "xt": sp.piece_to_id("[xt]")},
    )
    print(f"   turn events: {len(events['turn'])}, "
          f"xt events: {len(events['xt'])}")

    print("== 6. serving engine")
    engine = STEngine(
        transformer, cnn, seq_lin, ctc_lin, trainer.state.cmvn, sp,
        beam_size=3, bucket_seconds=(1.0, 2.0), bf16=False,
        turn_id=sp.piece_to_id("[turn]"), xt_id=sp.piece_to_id("[xt]"),
        device=device,
    )
    wav = dataset[0]["sig"]
    print(f"   translate([wav]) -> {engine.translate([wav])[0]!r}")
    asr, st = engine.transcribe_and_translate([wav])
    print(f"   transcribe_and_translate([wav]) -> ({asr[0]!r}, {st[0]!r})"
          "  (one encoder pass + one fused dual-prompt search)")

    print("== 7. long-form: whole conversation in one call")
    # two utterances separated by silence: VAD segments, the fused dual
    # search decodes every segment, texts merge with absolute-time RTTM
    gap = np.zeros(8000, np.float32)
    conversation = np.concatenate(
        [gap, dataset[0]["sig"], gap, dataset[1]["sig"], gap])
    result = engine.long_form(conversation, uri="demo")
    for seg in result["segments"]:
        print(f"   [{seg['start']:5.2f}-{seg['end']:5.2f}s] "
              f"asr={seg['transcription']!r}")
    print(f"   merged translation: {result['translation']!r}")

    print("== 8. continuous batching: in-flight request swapping")
    # a persistent greedy slot loop: requests admitted into freed slots
    # mid-decode, no head-of-line blocking
    from ..serving_continuous import ContinuousBatchingEngine

    cont = ContinuousBatchingEngine(engine, slots=2, chunk=4)
    try:
        futs = [cont.submit(dataset[i % 2]["sig"],
                            task=("translate" if i % 2 == 0
                                  else "transcribe"))
                for i in range(4)]
        for i, f in enumerate(futs):
            print(f"   slot-loop result {i}: {f.result(timeout=600)!r}")
        print(f"   slot utilization: {cont.utilization():.2f}")
    finally:
        cont.close()
    print("quickstart complete.")


if __name__ == "__main__":
    main()
