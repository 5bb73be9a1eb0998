"""Train the 5k-BPE tokenizer with language/turn special symbols (port of
``recipes/train_tokenizer.py``)::

    python -m stac_st_tpu_torch.recipes.train_tokenizer \\
        recipes/hparams/train_bpe_5k.yaml \\
        --train_json_file=... --output_folder=... [--languages="'[ES],[EN]'"]

Produces ``<output_folder>/<vocab>_bpe.model`` (+ .vocab) in SentencePiece
wire format with the id contract unk=0 bos=1 eos=2, user symbols from 3
(``tokenizer.train.SentencePiece``; the files equal the JAX package's).
"""

import sys

from stac_st_tpu_torch.config import (
    create_experiment_directory,
    load_hyperpyyaml,
    parse_arguments,
)


def main(argv):
    hparams_file, run_opts, overrides = parse_arguments(argv)
    with open(hparams_file) as fin:
        hparams = load_hyperpyyaml(fin, overrides)
    create_experiment_directory(
        hparams["output_folder"], hparams_file, overrides
    )
    tokenizer = hparams["tokenizer"]
    return tokenizer() if callable(tokenizer) else tokenizer


if __name__ == "__main__":
    main(sys.argv[1:])
