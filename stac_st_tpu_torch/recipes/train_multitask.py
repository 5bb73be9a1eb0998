"""Train the multitask ASR+ST Transformer on the port (port of
``recipes/train_multitask.py``)::

    python -m stac_st_tpu_torch.recipes.train_multitask \\
        recipes/hparams/transformer_multitask.yaml \\
        --data_folder=/path/to/data --tokenizer_file=/path/to/5000_bpe.model \\
        [--device=cpu] [--key=value overrides ...]

The hparams YAML is the composition root: the repository's YAMLs load
unchanged, every class path resolving onto the port's PyTorch modules
(``config.registry``). It runs on ``cuda`` unless ``--device=cpu`` is
given; CUDA asked for and absent raises. After ``fit`` (train, validate
with the dual beam search, keep the top 5 checkpoints by ACC; a SIGTERM
saves a checkpoint and returns, and the next run resumes from it), unless
``no_eval`` is set, each test split is evaluated on the average of the
kept checkpoints into ``bleu_<split>.txt`` / ``wer_<split>.txt`` (and their
``_no_turn`` variants) in the output folder; a split whose file is already
there is not decoded again. A run stopped by SIGTERM returns after its
checkpoint, without evaluating.

Data parallel over N cards, one process each::

    torchrun --nproc_per_node N -m stac_st_tpu_torch.recipes.train_multitask \\
        recipes/hparams/transformer_multitask.yaml --data_folder=... \\
        [--distributed_backend=gloo]

joins the process group (``nccl`` unless ``gloo`` is named), shards the
train and valid loaders' audio decoding by rank, and trains the global
batch the sampler forms (``training.trainer``); rank 0 writes the
experiment directory, the checkpoints and the evaluation files, which
hold every test row in order.
"""

import logging
import os
import sys

import torch

from stac_st_tpu_torch.config import (
    create_experiment_directory,
    load_hyperpyyaml,
    parse_arguments,
)
from stac_st_tpu_torch.data import (
    BatchLoader,
    DynamicBatchSampler,
    SpeechDataset,
    sort_ids,
    split_name,
)
from stac_st_tpu_torch.device import resolve_device
from stac_st_tpu_torch.models import glorot_init_
from stac_st_tpu_torch.parallel.distributed import (
    barrier,
    init_distributed,
    is_main_process,
)
from stac_st_tpu_torch.training.trainer import STTrainer
from stac_st_tpu_torch.utils.seeding import manual_seed

logger = logging.getLogger(__name__)


def make_dataset(hparams, split: str, train: bool) -> SpeechDataset:
    json_path = os.path.join(hparams["data_folder"], f"{split}.json")
    sp = hparams.get("speed_perturb") if train else None
    return SpeechDataset(
        json_path,
        tokenizer=hparams["tokenizer"],
        sample_rate=hparams.get("sample_rate", 16000),
        replacements={"data_root": hparams["data_folder"]},
        speed_perturb=sp,
        bos_index=hparams.get("bos_index", 1),
        eos_index=hparams.get("eos_index", 2),
        include_xt=hparams.get("use_xt_token", True),
        include_turn=hparams.get("use_turn_token", True),
    )


def init_weights(hparams) -> None:
    """Seeded Glorot weights for the modules of the YAML's ``model``, as
    the JAX trainer initializes its parameters from the experiment's seed
    (a resumed run then loads its checkpoint over them)."""
    gen = torch.Generator().manual_seed(int(hparams.get("seed", 8886)))
    for module in hparams["model"]:
        glorot_init_(module, gen)


def all_test_splits(hparams):
    return list(hparams.get("test_splits_4_translations", [])) + list(
        hparams.get("test_splits_1_translations", []))


def dataio_prepare(hparams):
    """Datasets and loaders for train/valid/test (reference dataio_prepare,
    ``train_multitask.py:481-621``)."""
    seed = int(hparams.get("seed", 8886))
    datasets, loaders = {}, {}

    train_ds = make_dataset(hparams, hparams["train_splits"], train=True)
    valid_ds = make_dataset(hparams, hparams["dev_splits"], train=False)
    datasets["train"], datasets["valid"] = train_ds, valid_ds

    sorting = hparams.get("sorting", "random")
    shuffle = sorting == "random"

    if hparams.get("dynamic_batching", False):
        dyn = hparams["dynamic_batch_sampler"]
        # the sampler keeps its own default seed (42), as the reference's
        # does (dataio_and_utils.py:212-230)
        train_sampler = DynamicBatchSampler(
            train_ds.durations(),
            dyn["max_batch_len"],
            num_buckets=dyn.get("num_buckets", 50),
            shuffle=dyn.get("shuffle_ex", True) and shuffle,
            batch_ordering=dyn.get("batch_ordering", "random"),
            max_batch_ex=dyn.get("max_batch_ex", 128),
            drop_last=dyn.get("drop_last", False),
            boundaries=dyn.get("boundaries", "sb_warped"),
        )
        valid_sampler = DynamicBatchSampler(
            valid_ds.durations(),
            dyn.get("max_batch_len_val", dyn["max_batch_len"]),
            num_buckets=dyn.get("num_buckets", 50),
            shuffle=dyn.get("shuffle_ex", True),
            batch_ordering=dyn.get("batch_ordering", "random"),
            boundaries=dyn.get("boundaries", "sb_warped"),
        )
        nw = int(hparams.get("train_dataloader_opts", {})
                 .get("num_workers", hparams.get("num_workers", 1)) or 1)
        tpm = int(hparams.get("token_pad_multiple", 32))
        loaders["train"] = BatchLoader(train_ds, sampler=train_sampler,
                                       seed=seed, num_workers=nw,
                                       token_pad_multiple=tpm)
        loaders["valid"] = BatchLoader(valid_ds, sampler=valid_sampler,
                                       seed=seed, num_workers=nw,
                                       token_pad_multiple=tpm)
    else:
        loaders["train"] = BatchLoader(
            train_ds, batch_size=hparams.get("batch_size", 4),
            shuffle=shuffle, seed=seed,
        )
        loaders["valid"] = BatchLoader(
            valid_ds, batch_size=hparams.get("batch_size", 4), seed=seed,
        )
        if sorting in ("ascending", "descending"):
            loaders["train"].order = sort_ids(train_ds, sorting)
            loaders["valid"].order = sort_ids(valid_ds, sorting)

    for split in all_test_splits(hparams):
        name = split_name(split)
        datasets[name] = make_dataset(hparams, split, train=False)
        loaders[name] = BatchLoader(
            datasets[name], batch_size=hparams.get("test_batch_size", 4),
            seed=seed,
        )
    return datasets, loaders


def main(argv):
    hparams_file, run_opts, overrides = parse_arguments(argv)
    resolve_device(run_opts["device"])  # CUDA asked for and absent raises
    backend = str(run_opts.get("distributed_backend"))
    init_distributed(backend if backend == "gloo" else "nccl")
    with open(hparams_file) as fin:
        hparams = load_hyperpyyaml(fin, overrides)

    manual_seed(int(hparams.get("seed", 8886)))
    if is_main_process():
        create_experiment_directory(
            hparams["output_folder"], hparams_file, overrides
        )
    barrier()
    logger.info("training for %s epochs (optimizer_step_limit %s)",
                hparams.get("number_of_epochs"),
                hparams.get("optimizer_step_limit"))

    hparams["pretrainer"].collect_files()
    hparams["pretrainer"].load_collected()

    datasets, loaders = dataio_prepare(hparams)
    init_weights(hparams)

    trainer = STTrainer(
        modules=hparams["modules"],
        opt_class=hparams["Adam"],
        hparams=hparams,
        run_opts=run_opts,
        checkpointer=hparams.get("checkpointer"),
    )
    if trainer.dp is not None:
        # every rank iterates the same global batches and decodes audio
        # only for its own row block (the block _device_batch ships)
        for name in ("train", "valid"):
            loaders[name].set_shard(trainer.dp.rank, trainer.dp.world,
                                    trainer._row_multiple)
    trainer.fit(
        hparams["epoch_counter"], loaders["train"], loaders["valid"]
    )
    if trainer.preempted:
        logger.info("stopped by SIGTERM: the next run resumes")
        return trainer

    if hparams.get("no_eval", True):
        logger.info("no_eval=True: training round only, skipping evaluation")
        return trainer

    for split in all_test_splits(hparams):
        name = split_name(split)
        out = hparams["output_folder"]
        hparams["bleu_file"] = os.path.join(out, f"bleu_{name}.txt")
        hparams["bleu_file_no_turn"] = os.path.join(
            out, f"bleu_{name}_no_turn.txt"
        )
        hparams["wer_file"] = os.path.join(out, f"wer_{name}.txt")
        hparams["wer_file_no_turn"] = os.path.join(
            out, f"wer_{name}_no_turn.txt"
        )
        present = os.path.isfile(hparams["bleu_file"]) or os.path.isfile(
            hparams["wer_file"])
        barrier()  # every rank reads the same answer before rank 0 writes
        if present:
            print(f"File present, not decoding again: {hparams['bleu_file']}")
            continue
        trainer.hparams.update(hparams)
        trainer.evaluate(loaders[name])
    return trainer


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    main(sys.argv[1:])
