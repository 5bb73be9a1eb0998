"""Standalone inference on the port: encode once, decode ASR + ST, emit
speaker-turn RTTM (port of ``recipes/inference.py``)::

    python -m stac_st_tpu_torch.recipes.inference \\
        recipes/hparams/transformer_inference.yaml \\
        --pretrained_path=... --tokenizer_file=... \\
        --inference_splits="path/a/data-asr path/b/data-st" [--device=cpu]

Per split: the trained experiment's average of its ACC-top-k checkpoints;
the encoder runs once per batch (the floor-mask ``encode``, no decoder
pass); the CTC head's frame argmax gives ``[turn]``/``[xt]`` events as
RTTM lines at 25 fps; the same encoder output is decoded under the ASR
and the ST prompt (one fused search); outputs are re-merged per
conversation with ``[turn]`` joins. Runs on ``cuda`` unless
``--device=cpu`` is given.
"""

import logging
import os
import sys

from stac_st_tpu_torch.config import (
    create_experiment_directory,
    load_hyperpyyaml,
    parse_arguments,
)
from stac_st_tpu_torch.data import BatchLoader, SpeechDataset
from stac_st_tpu_torch.device import resolve_device
from stac_st_tpu_torch.training.trainer import STTrainer
from stac_st_tpu_torch.utils.recipe_io import (
    append_gt_preds,
    print_inference_output,
)
from stac_st_tpu_torch.utils.rttm import extract_turn_events

logger = logging.getLogger(__name__)


def run_split(trainer, hparams, json_path: str) -> None:
    dataset_id = json_path.split("/")[-2] if "/" in json_path else json_path
    out = hparams["output_folder"]
    bleu_file = os.path.join(out, f"bleu_{dataset_id}-st.csv")
    wer_file = os.path.join(out, f"wer_{dataset_id}-asr.csv")
    if os.path.isfile(bleu_file) or os.path.isfile(wer_file):
        print(f"File present, not decoding again: {bleu_file}")
        return

    dataset = SpeechDataset(
        f"{json_path}.json",
        tokenizer=hparams["tokenizer"],
        sample_rate=hparams.get("sample_rate", 16000),
        replacements={"data_root": hparams.get("data_folder", "")},
    )
    loader = BatchLoader(
        dataset, batch_size=hparams.get("test_batch_size", 1)
    )
    tokenizer = hparams["tokenizer"]
    special = {"[turn]": hparams.get("turn", 7), "[xt]": hparams.get("xt", 8)}
    searcher = hparams["test_search"]

    ids_list, asr_list, st_list = [], [], []
    turn_events = {"turn": [], "xt": []}
    averaged = False
    for batch in loader:
        dev = trainer._device_batch(batch)
        trainer.ensure_state()
        if not averaged:
            trainer.on_evaluate_start()
            averaged = True
        # the floor-mask encode path with no decoder pass, as the
        # reference's standalone inference (inference.py:88-110)
        p_ctc, enc_out = trainer.encode_forward(
            trainer.state.params, trainer.state.cmvn, dev
        )
        n = len(batch.id)

        if hparams.get("get_rttm_files", False) and p_ctc is not None:
            ctc_argmax = p_ctc.argmax(-1).cpu().numpy()[:n]
            events = extract_turn_events(
                batch.id, ctc_argmax,
                {"turn": special["[turn]"], "xt": special["[xt]"]},
            )
            for key in turn_events:
                turn_events[key].extend(events[key])

        src, tgt = batch.source_lang[0], batch.target_lang[0]
        if hparams.get("number_of_tasks", 2) >= 2:
            hyps_asr, hyps_st = trainer._run_search_dual(
                searcher, enc_out, dev["sig_len"], src, tgt
            )
            decoded = [
                ("transcription", src, src, hyps_asr),
                ("translation", src, tgt, hyps_st),
            ]
        else:
            task = batch.task[0]
            t_lang = src if task == "transcription" else tgt
            decoded = [(task, src, t_lang, trainer._run_search(
                searcher, enc_out, dev["sig_len"], src, t_lang))]
        for task, s_lang, t_lang, hyps in decoded:
            hyps = hyps[:n]
            refs = (
                batch.extras.get("translation_0")
                if task == "translation"
                else batch.extras.get("transcription")
            )
            ids, _, preds = append_gt_preds(
                batch.id, refs, hyps, t_lang, tokenizer,
                remove_special_chars=True, chars_dict=special,
            )
            for utt_id, pred in zip(ids, preds):
                if utt_id not in ids_list:
                    ids_list.append(utt_id)
                (st_list if task == "translation" else asr_list).append(pred)

    ground_truth = os.path.join(os.path.dirname(json_path), "data.json")
    if not os.path.isfile(ground_truth):
        ground_truth = f"{json_path}.json"
    if asr_list:
        print_inference_output(ids_list, ground_truth, asr_list, wer_file)
    if st_list:
        print_inference_output(ids_list, ground_truth, st_list, bleu_file)

    for name in ("turn", "xt"):
        path = os.path.join(out, f"RTTM_{dataset_id}_{name}.csv")
        with open(path, "w") as f:
            for line in turn_events[name]:
                f.write(line + "\n")


def main(argv):
    hparams_file, run_opts, overrides = parse_arguments(argv)
    resolve_device(run_opts["device"])  # CUDA asked for and absent raises
    with open(hparams_file) as fin:
        hparams = load_hyperpyyaml(fin, overrides)
    create_experiment_directory(
        hparams["output_folder"], hparams_file, overrides
    )
    hparams["pretrainer"].collect_files()
    hparams["pretrainer"].load_collected()

    trainer = STTrainer(
        modules=hparams["modules"],
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams.get("checkpointer"),
    )
    for json_path in hparams["inference_splits"].split(" "):
        if json_path:
            run_split(trainer, hparams, json_path)
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main(sys.argv[1:])
