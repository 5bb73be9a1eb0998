"""Data-parallel training in the port: two gloo ranks on the CPU.

One spawn of two processes (``torch.distributed`` over gloo, TCP on
localhost) runs, on every rank:

(a) one train step of the tiny model (d32, 4 heads, 2 + 2 layers, vocab
    50, 16 mels, CNN (8, 8); fp32, CTC 0.3, label smoothing 0.1,
    batchmean) on an odd global batch of 5 rows, padded to 6, dropout 0,
    the CMVN update on; then two steps with dropout 0.1 and SpecAugment;
(b) the tiny recipe (``recipes.train_multitask.main``, the fixture corpus
    of ``tests/fixtures.py``, vocab 150, batches of 3 padded to 4, one
    epoch of three steps, the dual validation search): an uninterrupted
    run, a run whose rank 1 alone receives a SIGTERM during its first
    step, and the run that resumes from it inside the epoch.

The parent holds (a) against the JAX trainer's step over a 2-device data
mesh (``STTrainer(run_opts={"data_parallel_count": 2})``, the tolerances
of ``tests/test_train_oracle.py``: loss rtol 2e-5, parameters rtol 5e-3 /
atol 5e-4, CMVN statistics rtol 1e-6, its count and the counters equal)
and the dropout run against the port's one-rank step on the same padded
batch (loss rtol 1e-6, parameters atol 1e-6); (b)'s joint stop, its
bitwise resume and rank 0's files in a one-rank engine. The children
import no JAX (the module imports it inside its fixtures only).
"""

import os
import signal
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
import torch.distributed as dist
import torch.multiprocessing as mp

from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.data.dataset import collate_batch, pad_batch_rows
from stac_st_tpu_torch.ops.cmvn import CmvnState
from stac_st_tpu_torch.ops.fbank import Fbank
from stac_st_tpu_torch.ops.specaugment import SpecAugment
from stac_st_tpu_torch.parallel.distributed import init_distributed
from stac_st_tpu_torch.recipes import train_multitask as R
from stac_st_tpu_torch.training.optim import AdamW
from stac_st_tpu_torch.training.schedulers import WarmCoolDecayLRSchedule
from stac_st_tpu_torch.training.trainer import STTrainer

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_recipe import YAML, _overrides, _state  # noqa: E402

D, H, LAYERS, FFN, VOCAB, N_MELS, CH = 32, 4, 2, 64, 50, 16, 8
LR = 5e-3
SCHED = dict(warmup=20, cooldown=10, total_steps=100, decay_factor=0.75,
             decay_every=10.0)
WAV_LEN, U, ROWS = 8000, 8, 5
SPECAUG = dict(time_warp_window=2, freq_mask_width=4, time_mask_width=6)
RANKS_TIMEOUT_S = 300  # a hung collective fails the test, not the run


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ tiny model
def _modules(dropout: float):
    """Seeded port modules, and the trainer's modules dict."""
    gen = torch.Generator().manual_seed(3)
    mods = dict(
        CNN=P.ConvolutionFrontEnd(n_mels=N_MELS, out_channels=(CH, CH),
                                  dropout=dropout),
        Transformer=P.TransformerMultiTask(
            VOCAB, (N_MELS // 4) * CH, d_model=D, nhead=H,
            num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
            dropout=dropout),
        seq_lin=P.LinearHead(D, VOCAB), ctc_lin=P.LinearHead(D, VOCAB))
    for m in mods.values():
        P.glorot_init_(m, gen)
    return mods


def _trainer(dropout=0.0, specaug=False, **run_opts):
    hp = dict(compute_features=Fbank(n_mels=N_MELS), ctc_weight=0.3,
              label_smoothing=0.1, loss_reduction="batchmean",
              n_mels=N_MELS, seed=11,
              lr_scheduler=WarmCoolDecayLRSchedule(lr=LR, **SCHED))
    if specaug:
        hp["augmentation"] = SpecAugment(**SPECAUG)
    trainer = STTrainer(_modules(dropout), AdamW(lr=LR), hp, run_opts,
                        device="cpu")
    st = trainer.ensure_state()
    mean, std = _cmvn()
    st.cmvn = CmvnState(torch.from_numpy(mean), torch.from_numpy(std),
                        torch.tensor(100.0))
    return trainer


def _cmvn():
    rng = np.random.default_rng(4)
    return (rng.standard_normal(N_MELS).astype(np.float32),
            (0.5 + rng.random(N_MELS)).astype(np.float32))


def _batch():
    """An odd global batch of ROWS utterances of varied lengths."""
    rng = np.random.default_rng(5)
    samples = []
    for r in range(ROWS):
        n, k = int(WAV_LEN * (1.0 - 0.1 * r)), 3 + r % 3
        seq = rng.integers(3, VOCAB, k)
        samples.append(dict(
            id=f"u{r}", sig=(0.1 * rng.standard_normal(n)).astype(np.float32),
            duration=n / 16000, task="translation", source_lang="es",
            target_lang="en", tokens=seq,
            tokens_bos=np.concatenate([[1], seq]),
            tokens_eos=np.concatenate([seq, [2]])))
    return collate_batch(samples, audio_pad_samples=WAV_LEN,
                         token_pad_multiple=U)


def _padded(batch, multiple=2):
    """The whole global batch as one device batch, padded as a mesh pads
    it (zero-length rows)."""
    arrays = {"sig": batch.sig.data, "sig_len": batch.sig.lengths,
              "tokens": batch.tokens.data, "tokens_len": batch.tokens.lengths,
              "tokens_bos": batch.tokens_bos.data,
              "tokens_eos": batch.tokens_eos.data,
              "tokens_eos_len": batch.tokens_eos.lengths}
    return {k: (torch.from_numpy(v).long() if k.startswith("tok")
                and v.dtype.kind == "i" else torch.from_numpy(v))
            for k, v in pad_batch_rows(arrays, multiple).items()}


def _snapshot(trainer, metrics):
    st = trainer.state
    return dict(loss=float(metrics["loss"]), flat=st.params.flat.clone(),
                grad_norm=float(metrics["grad_norm"]),
                named={k: v.detach().clone()
                       for k, v in st.params.named().items()},
                mean=st.cmvn.mean.clone(), std=st.cmvn.std.clone(),
                count=float(st.cmvn.count),
                counters=(st.optimizer_step, st.micro_step))


# ---------------------------------------------------------------- ranks
def _recipe(corpus, out, rank, sigterm=False):
    """The tiny recipe on this rank; with ``sigterm``, rank 1 receives
    SIGTERM as its first step begins."""
    args = [YAML, "--device=cpu", "--distributed_backend=gloo"] + [
        f"--{k}={'null' if v is None else v}" for k, v in _overrides(
            corpus, out, number_of_epochs=1, valid_search_interval=1,
            num_workers=1, no_eval=True, batch_size=3,
            dynamic_batching=False).items()]
    original = STTrainer.next_seed
    if sigterm and rank == 1:
        def next_seed(self):
            if not getattr(self, "_signalled", False):
                self._signalled = True
                signal.raise_signal(signal.SIGTERM)
            return original(self)
        STTrainer.next_seed = next_seed
    try:
        trainer = R.main(args)
    finally:
        STTrainer.next_seed = original
    return trainer


def _worker(rank, world, port, out, corpus):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    assert init_distributed("gloo")
    res = {}
    batch = _batch()
    trainer = _trainer(data_parallel_count=world)
    dev = trainer._device_batch(batch)
    res["local_rows"] = int(dev["sig"].shape[0])
    _, m = trainer.train_step(trainer.state, dev, 7, update_cmvn=True)
    res["step"] = _snapshot(trainer, m)
    trainer = _trainer(0.1, True, data_parallel_count=-1)
    _, m = trainer.train_step(trainer.state, trainer._device_batch(batch),
                              trainer.next_seed(), update_cmvn=True)
    res["dropout"] = _snapshot(trainer, m)

    whole = _recipe(corpus, os.path.join(out, "whole"), rank)
    res["whole"] = _state(whole)
    res["whole_valid"] = whole.last_valid_stats
    cut = _recipe(corpus, os.path.join(out, "cut"), rank, sigterm=True)
    res["cut"] = (cut.preempted, cut.state.micro_step)
    resumed = _recipe(corpus, os.path.join(out, "cut"), rank)
    res["resumed"] = _state(resumed)
    res["resumed_valid"] = resumed.last_valid_stats
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from stac_st_tpu_torch.tokenizer.train import SentencePiece

    from fixtures import make_corpus

    root = str(tmp_path_factory.mktemp("dp_corpus"))
    _, _, joint = make_corpus(root, n_utts=8, seconds=0.5)
    tok = SentencePiece(
        model_dir=root, vocab_size=150, annotation_train=joint,
        annotation_read="transcription_and_translation", model_type="bpe",
        user_defined_symbols="[es],[en],[turn],[xt]", bos_id=1, eos_id=2,
        unk_id=0)
    return {"root": root, "tokenizer": tok.model_path}


def _jax_mesh_step():
    """The JAX trainer's step over a 2-device data mesh (the 5 rows padded
    to 6, sharded) from the same weights, CMVN and batch: its metrics and
    state, as numpy."""
    import jax
    import jax.numpy as jnp

    from stac_st_tpu.ops import Fbank as JFbank
    from stac_st_tpu.ops.cmvn import CmvnState as JCmvn
    from stac_st_tpu.training import step as jstep
    from stac_st_tpu.training.optim import AdamW as JAdamW
    from stac_st_tpu.training.schedulers import (
        WarmCoolDecayLRSchedule as JSched,
    )
    from stac_st_tpu.training.trainer import STTrainer as JaxTrainer
    from stac_st_tpu_torch.interop.from_jax import to_jax_params
    from test_torch_train_step import _jax_cfg

    cfg = _jax_cfg()
    jt = JaxTrainer(
        {"CNN": cfg.cnn, "Transformer": cfg.transformer,
         "seq_lin": cfg.seq_lin, "ctc_lin": cfg.ctc_lin}, JAdamW(lr=LR),
        dict(compute_features=JFbank(n_mels=N_MELS), ctc_weight=0.3,
             label_smoothing=0.1, loss_reduction="batchmean", n_mels=N_MELS,
             lr_scheduler=JSched(lr=LR, **SCHED)),
        run_opts={"data_parallel_count": 2})
    assert jt.mesh.shape["data"] == 2 and jt._row_multiple == 2
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(*(
        _modules(0.0)[k] for k in ("CNN", "Transformer", "seq_lin",
                                   "ctc_lin"))))
    mean, std = _cmvn()
    state = jstep.TrainState(
        params=params, opt_state=jax.jit(jt.tx.init)(params),
        cmvn=JCmvn(jnp.array(mean), jnp.array(std),
                   jnp.asarray(100.0, jnp.float32)),
        optimizer_step=jnp.zeros((), jnp.int32),
        micro_step=jnp.zeros((), jnp.int32))
    dev = jt._device_batch(_batch())
    assert dev["sig"].shape[0] == 6
    state, m = jt.train_step(state, dev, jax.random.PRNGKey(0),
                             update_cmvn=True)
    return jax.tree_util.tree_map(np.asarray, (m, state))


@pytest.fixture(scope="module")
def ranks(corpus, tmp_path_factory):
    """The two ranks' results, and what this process computes while they
    run: the JAX mesh step, and the port's one-rank step with dropout and
    SpecAugment on the padded global batch (with its gradient)."""
    from stac_st_tpu_torch.training.step import loss_and_grad

    out = str(tmp_path_factory.mktemp("dp_ranks"))
    ctx = mp.spawn(_worker, args=(2, _free_port(), out, corpus), nprocs=2,
                   join=False)
    try:
        jax_step = _jax_mesh_step()
        one = _trainer(0.1, True)
        batch, seed = _padded(_batch()), one.next_seed()
        grad = loss_and_grad(one.cfg, one.state, batch, seed)[1]
        _, m = one.train_step(one.state, batch, seed, update_cmvn=True)
        one_rank = (_snapshot(one, m), grad)
    finally:
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                pytest.fail(f"the ranks ran over {RANKS_TIMEOUT_S} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(2)] + [out, jax_step, one_rank]


# ---------------------------------------------------------------- tests
def test_two_rank_step_equals_the_jax_data_mesh_step(ranks):
    """The JAX trainer's step over a 2-device data mesh (the 5 rows padded
    to 6, sharded) from the same weights, CMVN and batch."""
    from test_torch_train_step import _assert_params, _as_port_named

    got = ranks[0]["step"]
    assert ranks[0]["local_rows"] == ranks[1]["local_rows"] == 3
    m, state = ranks[3]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=2e-5)
    _assert_params(got["named"], _as_port_named(state.params), rtol=5e-3,
                   atol=5e-4)
    np.testing.assert_allclose(got["mean"].numpy(),
                               np.asarray(state.cmvn.mean), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got["std"].numpy(),
                               np.asarray(state.cmvn.std), rtol=1e-6)
    assert got["count"] == float(state.cmvn.count) == 106.0
    assert got["counters"] == (int(state.optimizer_step),
                               int(state.micro_step)) == (1, 1)


def test_two_rank_step_equals_one_rank_step_with_dropout_and_specaugment(
        ranks):
    """Dropout 0.1 (the flash kernels' hash and the plain masks) and
    SpecAugment: the ranks hold one state, the one the port's one-rank
    trainer reaches on the padded global batch with the same seed. The
    key-projection biases, whose true gradient is 0, are held as
    chip_smoke.py's card-vs-CPU step holds them (Adam turns
    rounding noise into +-lr)."""
    a, b = ranks[0]["dropout"], ranks[1]["dropout"]
    assert torch.equal(a["flat"], b["flat"])
    want, grad = ranks[4]
    np.testing.assert_allclose(a["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(a["grad_norm"], want["grad_norm"], rtol=1e-6)
    # Adam's first update is lr * g/|g|: where |g| stands above the
    # summation-order noise the updates agree to fp32 rounding, elsewhere
    # (the key-projection biases, whose true gradient is 0) each side's
    # sign is noise, as in chip_smoke.py's card-vs-CPU step
    sure = grad.abs() > 1e-3 * grad.abs().max()
    d = (a["flat"] - want["flat"]).abs()
    assert float(d[sure].max()) <= 1e-6 and float(d.max()) <= 2 * LR * 1.001
    assert 0.75 < float(sure.float().mean()) < 1.0
    torch.testing.assert_close(a["mean"], want["mean"], atol=1e-6, rtol=0)
    assert a["count"] == want["count"] == 106.0
    # dropout moved the step: the same batch without it lands elsewhere
    assert float((a["flat"] - ranks[0]["step"]["flat"]).abs().max()) > 1e-4


def test_sigterm_to_one_rank_stops_both_after_the_same_step(ranks):
    """Rank 1 alone is signalled during step 1; the flags' all-reduce is
    read one step late, so both ranks stop after step 2, preempted."""
    assert ranks[0]["cut"] == ranks[1]["cut"] == (True, 2)


def test_resumed_two_rank_recipe_is_bitwise_the_uninterrupted_one(ranks):
    """The resumed run re-enters epoch 1, skips the two trained batches,
    trains the third and validates (the dual search, hypotheses gathered
    in global row order): it ends where the uninterrupted run ends, bit
    for bit, on both ranks, and rank 0 wrote the same checkpoint files."""
    saves = [os.path.join(ranks[2], run, "save") for run in ("whole", "cut")]
    newest = [max(n for n in os.listdir(d) if n.startswith("CKPT+"))
              for d in saves]
    names = sorted(f for f in os.listdir(os.path.join(saves[0], newest[0]))
                   if f.endswith(".msgpack"))
    assert "model.msgpack" in names and "opt_torch.msgpack" in names
    for name in names:  # the files rank 0 wrote, byte for byte
        data = [open(os.path.join(d, n, name), "rb").read()
                for d, n in zip(saves, newest)]
        assert data[0] == data[1], name
    for r in ranks[:2]:
        assert set(r["resumed"]) == set(r["whole"])
        for key, want in r["whole"].items():
            assert torch.equal(r["resumed"][key], want), key
        assert r["resumed_valid"] == r["whole_valid"]
        assert {"loss", "ACC", "BLEU", "WER"} <= set(r["whole_valid"])
    assert torch.equal(ranks[0]["whole"]["flat"], ranks[1]["whole"]["flat"])


def test_rank0_experiment_loads_into_one_rank(ranks, corpus, tmp_path):
    """Rank 0 wrote the experiment. A one-process trainer resumes from
    its checkpoint and writes, for that state, files byte-equal to rank
    0's; the checkpoint loads into a one-device ``STEngine``, which
    serves."""
    from stac_st_tpu_torch.serving import STEngine
    from stac_st_tpu_torch.training.checkpoint import (
        Checkpointer,
        average_checkpoints,
    )
    from test_torch_recipe import _assert_engine_holds, _hparams
    from test_torch_recipe import _trainer as recipe_trainer

    out = os.path.join(ranks[2], "whole")
    ckpts = Checkpointer(os.path.join(out, "save")).find_checkpoints(
        max_key="ACC")
    assert len(ckpts) == 1  # the epoch's validation
    one = recipe_trainer(_hparams(corpus, out))
    one.ensure_state()
    assert one.dp is None and one.state.micro_step == 3
    mine = Checkpointer(str(tmp_path)).save_checkpoint(
        {"epoch": 1}, one._checkpoint_trees(1))
    names = sorted(n for n in os.listdir(ckpts[0].path)
                   if n.endswith(".msgpack"))
    assert names == sorted(n for n in os.listdir(mine.path)
                           if n.endswith(".msgpack"))
    for name in names:
        with open(os.path.join(ckpts[0].path, name), "rb") as f, \
                open(os.path.join(mine.path, name), "rb") as g:
            assert f.read() == g.read(), name
    engine = STEngine.from_saved_experiment(out, device="cpu", bf16=False)
    _assert_engine_holds(engine, average_checkpoints(ckpts, "model"))
    wav = engine.load_audio(os.path.join(corpus["root"], "wav",
                                         "utt000.wav"))
    assert isinstance(engine.translate([wav])[0], str)


@pytest.mark.parametrize("case", ["data_parallel_count", "nccl",
                                  "pipeline_stages"])
def test_refusals_name_what_to_change(case):
    if case == "data_parallel_count":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            _trainer(data_parallel_count=2)
    elif case == "nccl":  # no card here: two local ranks want two
        with pytest.raises(ValueError, match="nccl needs one card"):
            init_distributed(rank=1, world_size=2, local_rank=1)
    else:
        with pytest.raises(ValueError, match="pipeline_stages=2"):
            _trainer(pipeline_stages=2)
