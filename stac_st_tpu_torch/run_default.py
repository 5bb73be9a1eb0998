"""Default pipeline: train the tokenizer (if missing), then train STAC-ST
with the port (port of ``run_default.py``: the same recipe command lines).

Mirrors the reference script (``run_default.sh:17-80``): 5k BPE tokenizer on
the joint transcription+translation field, then multitask training with the
canonical small-model configuration, through
``stac_st_tpu_torch.recipes.{train_tokenizer,train_multitask}``. Paths of
the YAMLs are relative to the repository root, so run it from there. The
recipe runs on the card; extra overrides pass through (``--device=cpu``,
``--precision=fp32``, ...). For several cards run it under ``torchrun``
(one rank a card: ``torchrun --nproc_per_node N -m
stac_st_tpu_torch.run_default ...``).

    python -m stac_st_tpu_torch.run_default --data_folder /path/to/data \\
        [--train_split fisher-callhome-train-and-30s/data-turns-asr-st] \\
        [--tokenizer_dir exp/tokenizer_bpe_5k_es_en] [extra overrides...]
"""

import argparse
import os
import sys


def build_argvs(argv=None):
    """(tokenizer recipe argv or None when the model file exists, training
    recipe argv)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_folder", required=True)
    parser.add_argument(
        "--train_split",
        default="fisher-callhome-train-and-30s/data-turns-asr-st",
    )
    parser.add_argument("--tokenizer_dir", default="exp/tokenizer_bpe_5k_es_en")
    parser.add_argument("--output", default="exp/stac-st/")
    parser.add_argument("--seed", type=int, default=3333)
    args, extra = parser.parse_known_args(argv)

    tokenizer_model = os.path.join(args.tokenizer_dir, "5000_bpe.model")
    tok_argv = None
    if not os.path.isfile(tokenizer_model):
        tok_argv = [
            os.path.join("recipes", "hparams", "train_bpe_5k.yaml"),
            f"--train_json_file={args.data_folder}/{args.train_split}.json",
            f"--output_folder={args.tokenizer_dir}",
        ]
    train_argv = [
        os.path.join("recipes", "hparams", "transformer_multitask.yaml"),
        f"--seed={args.seed}",
        "--use_xt_token=True", "--use_turn_token=True",
        "--encoder_module=transformer",
        "--attention_type=regularMHA",
        f"--train_splits={args.train_split}",
        f"--output_folder_name={args.output}",
        "--max_batch_len=500", "--max_batch_len_val=250",
        "--test_batch_size=1",
        "--lr_adam=0.001", "--transformer_dropout=0.1",
        "--grad_accumulation_factor=8",
        "--scheduler_step_limit=100000",
        "--n_warmup_steps=10000", "--cooldown=10000",
        "--ctc_weight=0.3",
        "--d_model=256", "--d_ffn=1024", "--nhead=4",
        "--num_encoder_layers=12", "--num_decoder_layers=6",
        "--valid_search_interval=100",
        f"--data_folder={args.data_folder}",
        f"--tokenizer_file={tokenizer_model}",
    ] + extra
    return tok_argv, train_argv


def main(argv=None):
    tok_argv, train_argv = build_argvs(argv)
    if tok_argv is not None:
        print(f"training the tokenizer in {tok_argv[-1].split('=', 1)[1]}")
        from .recipes.train_tokenizer import main as tok_main

        tok_main(tok_argv)
    else:
        print("skipping training Tokenizer, already prepared")

    from .recipes.train_multitask import main as train_main

    train_main(train_argv)


if __name__ == "__main__":
    main(sys.argv[1:])
