"""The ST trainer: fit and evaluate loops, validation, checkpoints and
resume, on one device or data-parallel over ranks (port of
``stac_st_tpu/training/trainer.py``).

``STTrainer`` builds the step configuration from the modules and hparams
(precision, losses, SpecAugment, device speed perturbation, the optimizer
chain), creates the train state from the weights the modules hold, moves
each ``PaddedBatch`` to the device (PCM16 when ``transfer_int16`` is set;
the ``speed_idx`` column when the loader drew one), and runs:

* ``fit(epoch_counter, train_set, valid_set=None, ...)``: per epoch,
  ``set_epoch`` (which keys the loader's shuffle and speed draw), the CMVN
  update gate, one train step per batch, timed checkpoints every
  ``ckpt_interval_minutes``; then validation, the train logger's line and
  the top-5-by-ACC checkpoint; ``optimizer_step_limit`` and the debug
  limits. A SIGTERM during ``fit`` (in the main thread) only sets a flag:
  after the step in flight, a ``preempted`` checkpoint is written from
  host copies and ``fit`` returns, with the previous handler restored;
* validation (``_validate``): the teacher-forced loss and ACC, and every
  ``valid_search_interval`` epochs the dual ASR + ST beam search, fused
  into one search while ``2·B·beam <= DUAL_FUSE_MAX_ROWS``; BLEU and WER
  with and without ``[turn]``/``[xt]``;
* ``evaluate``: the ACC-top-k average (``on_evaluate_start``), then the
  test split's search and its BLEU/WER files.

Checkpoints hold the trees both packages read, in the JAX layouts:
``model`` (``interop.from_jax.to_jax_params``), ``normalizer`` (``mean``,
``std``, ``count``) and ``counters`` (``optimizer_step``, ``micro_step``,
``epoch``). The port's optimizer state goes in ``opt_torch``: Adam's
``mu``/``nu`` (flat, in the port's parameter order), ``count``,
``notfinite``, ``total_notfinite``, ``sched_count``, the accumulator, and
the state of the trainer's step-seed generator, so a resumed run draws the
seeds the uninterrupted run would have drawn. The same optimizer state
also goes in ``opt``, the JAX trainer's optax layout
(``interop.from_jax.optax_opt_tree``: moments and accumulator mapped to
the parameters' JAX layout, the counts, the nonfinite counters and the
schedule's count), so the JAX trainer resumes a port checkpoint with its
moments; a checkpoint that holds ``opt`` and no ``opt_torch`` (the JAX
trainer's) is read the same way. Only a tree of another chain (another
accumulation, clipping, patience or optimizer) restarts the moments
(logged). A checkpoint written
inside epoch k (``preempted`` or ``timed``) also records in its meta the
losses of the batches epoch k had trained (``epoch_losses``); the resumed
run re-enters epoch k, reads those batches from the loader again without
training them (its order and speed draws are keyed by the epoch) and goes
on from the next one, so it ends where the uninterrupted run ends. One
written at the end of epoch k resumes at epoch k + 1.

Randomness: one CPU ``torch.Generator`` per trainer, seeded from
``hparams["seed"]``; each step draws its integer seed from it.

Validation searches with the trainer's fp32 weights, as the JAX trainer
binds its fp32 ``state.params``; on the card that takes the decode
kernels' fp32 (``simt``) variants.

Data parallelism: one process per card (``torchrun``, then
``parallel.distributed.init_distributed``); ``data_parallel_count`` -1
means the process group's world size, and any other value must equal it.
Each rank ships its row block of the global batch, padded with zero-length
rows to a multiple of the world size (``_device_batch``; the loader's
``set_shard`` decodes audio for the same block), and its step computes
the global step (``training.step``). Validation searches each rank's rows
and gathers the hypotheses in global row order before BLEU/WER; losses,
ACC and metrics are reduced over ranks. Only rank 0 writes checkpoints,
then every rank waits at a barrier; every rank resumes from rank 0's
files. A SIGTERM sets the rank's flag; a one-element all-reduce of the
flags is dispatched every step and read one step late (all in flight are
read at the epoch's end), so every rank stops after the same step.

Run options: ``train_attn_kernel`` ``auto`` (the default) and ``on``
send key-padding attention of the train step to ``flash_attention_train``
and of the teacher-forced eval forward to ``flash_attention``, the JAX
package's route on its accelerator; ``off`` sends both down the model's
matmul + softmax path, dropout on the weights in training (the JAX
package's XLA route). ``rng_impl`` takes every value the JAX trainer takes
(``rbg``, ``unsafe_rbg``, ``threefry``, each also ``_scoped``); the port's
one counter-based dropout RNG serves them all (logged once), and another
value raises ``ValueError``. Pipeline stages are not ported
(``pipeline_stages`` > 1 raises by name).
"""

from __future__ import annotations

import logging
import shutil
import signal
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.dataset import pad_batch_rows
from ..device import resolve_device
from ..interop.from_jax import (
    load_jax_params,
    optax_opt_fields,
    optax_opt_tree,
    to_jax_params,
)
from ..ops.cmvn import CmvnState
from ..parallel.distributed import (
    barrier,
    data_parallel,
    gather_to_host,
    is_main_process,
    process_row_block,
)
from ..utils.profiling import StepTimer
from ..utils.recipe_io import append_4gt, append_gt_preds, print_bleu_or_wer
from .checkpoint import average_checkpoints
from .step import (
    StepConfig,
    TrainState,
    global_metrics,
    init_train_state,
    make_encode_forward,
    make_eval_forward,
    make_optimizer,
    make_train_step,
    objectives,
)

logger = logging.getLogger(__name__)

__all__ = ["STTrainer", "RNG_IMPLS", "TRAIN_ATTN_KERNEL", "check_rng_impl"]

#: the JAX trainer's rng_impl values (each also with ``_scoped``)
RNG_IMPLS = ("rbg", "unsafe_rbg", "threefry")
TRAIN_ATTN_KERNEL = ("auto", "on", "off")
_rng_logged = False


def check_rng_impl(value) -> str:
    """The run option ``rng_impl``, lower-cased as the JAX trainer reads
    it; ``ValueError`` where the JAX trainer would fail."""
    global _rng_logged
    impl = str(value).lower()
    base = impl[:-len("_scoped")] if impl.endswith("_scoped") else impl
    if base not in RNG_IMPLS:
        raise ValueError(f"rng_impl={value!r}: expected one of "
                         f"{', '.join(RNG_IMPLS)}, each also with _scoped")
    if not _rng_logged:
        _rng_logged = True
        logger.info("rng_impl=%s: the port's counter-based dropout RNG "
                    "serves every rng_impl value", impl)
    return impl


def _specaug_opts(hparams) -> Optional[tuple]:
    aug = hparams.get("augmentation")
    if aug is None or not hasattr(aug, "opts"):
        return None
    return tuple(sorted(aug.opts.items()))


class STTrainer:
    """Drives training and evaluation of the multitask ASR+ST model on
    ``device`` if given, else ``run_opts["device"]``, else cuda (under
    ``torchrun``, this rank's card)."""

    def __init__(self, modules: Dict[str, Any], opt_class=None,
                 hparams: Optional[Dict[str, Any]] = None,
                 run_opts: Optional[Dict[str, Any]] = None,
                 checkpointer=None, device=None):
        self.hparams = dict(hparams or {})
        self.run_opts = dict(run_opts or {})
        self.checkpointer = checkpointer
        self.modules = modules
        self.device = resolve_device(
            device if device is not None else self.run_opts.get("device"))
        h = self.hparams
        stages = int(self.run_opts.get("pipeline_stages",
                                       h.get("pipeline_stages", 1)) or 1)
        if stages > 1:
            raise ValueError(
                f"pipeline_stages={stages}: the port trains data-parallel "
                f"only (pipeline stages are not ported)")
        self.rng_impl = check_rng_impl(self.run_opts.get("rng_impl", "rbg"))
        tak = str(self.run_opts.get("train_attn_kernel", "auto")).lower()
        if tak not in TRAIN_ATTN_KERNEL:
            raise ValueError(f"train_attn_kernel={tak!r}: expected one of "
                             f"{', '.join(TRAIN_ATTN_KERNEL)}")
        self.attn_kernel = tak != "off"
        self.dp = data_parallel(self.run_opts.get("data_parallel_count", -1))
        # rows of a global batch are padded to a multiple of the world size
        self._row_multiple = self.dp.world if self.dp is not None else 1

        precision = str(self.run_opts.get("precision", "") or "").lower()
        if precision == "fp32":
            compute_dtype = None
        elif precision == "bf16":
            compute_dtype = torch.bfloat16
        else:
            compute_dtype = torch.bfloat16 if h.get("auto_mix_prec") else None

        self.cfg = StepConfig(
            fbank=h["compute_features"],
            cnn=modules["CNN"],
            transformer=modules["Transformer"],
            seq_lin=modules["seq_lin"],
            ctc_lin=modules.get("ctc_lin", modules["seq_lin"]),
            specaug_opts=_specaug_opts(h),
            ctc_weight=float(h.get("ctc_weight", 0.0)),
            label_smoothing=float(h.get("label_smoothing", 0.0)),
            loss_reduction=h.get("loss_reduction", "batchmean"),
            pad_index=int(h.get("pad_index", 0)),
            blank_index=int(h.get("blank_index", 0)),
            compute_dtype=compute_dtype,
            device_speed=(h.get("speed_perturb")
                          if getattr(h.get("speed_perturb"), "device", False)
                          else None),
            dp=self.dp,
        )
        if hasattr(self.cfg.transformer, "use_attention_kernels"):
            self.cfg.transformer.use_attention_kernels(self.attn_kernel)
        self.normalize = modules.get("normalize")
        scheduler = h.get("lr_scheduler")
        factory = opt_class if opt_class is not None else h.get("Adam")
        if factory is not None:
            self.tx = make_optimizer(
                factory,
                scheduler.value if scheduler is not None
                else (lambda step: h.get("lr_adam", 1e-3)),
                grad_accumulation_factor=int(
                    h.get("grad_accumulation_factor", 1)),
                # clipping is opt-in, as in the reference recipe
                max_grad_norm=(h.get("max_grad_norm")
                               if h.get("use_grad_clipping") else None),
                nonfinite_patience=int(h.get("nonfinite_patience", 100)),
            )
            self.train_step = make_train_step(self.cfg, self.tx)
        else:
            # eval-only construction (the inference recipe passes no
            # optimizer)
            self.tx = None
            self.train_step = None
        self.eval_forward = make_eval_forward(self.cfg)
        self.encode_forward = make_encode_forward(self.cfg)

        self.state: Optional[TrainState] = None
        self.optimizer_step_limit = int(h.get("optimizer_step_limit", 10**9))
        self._transfer_int16 = bool(self.run_opts.get("transfer_int16"))
        self.generator = torch.Generator().manual_seed(
            int(h.get("seed", 8886)))
        self.train_stats: Dict[str, float] = {}
        self.last_valid_stats: Dict[str, Any] = {}
        self.epoch_losses: List[torch.Tensor] = []  # last epoch, per step
        self.valid_search_s = 0.0  # the last validation's search time
        self.preempted = False  # the last fit stopped on SIGTERM
        # (epoch, losses of its trained batches) from a checkpoint written
        # inside that epoch, until fit re-enters it
        self._resume_inside: Optional[tuple] = None
        self.debug = bool(self.run_opts.get("debug", False))
        self.debug_batches = int(self.run_opts.get("debug_batches", 2))

    # ------------------------------------------------------------ state mgmt
    def ensure_state(self, sample_batch=None) -> TrainState:
        """The train state, created at the first call from the weights the
        modules hold, then resumed from the checkpointer's latest
        checkpoint if it has one."""
        if self.state is None:
            self.state = init_train_state(
                self.cfg, self.tx, self.device,
                int(self.hparams.get("n_mels", 80)))
            logger.info("initialized %d parameters", self.state.params.numel)
            self._maybe_resume()
        return self.state

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator))

    def _maybe_resume(self) -> None:
        if self.checkpointer is None:
            return
        latest = self.checkpointer.recover_if_possible()
        if latest is None:
            return
        self.load_from_checkpoint(latest)
        logger.info("resumed from %s", latest.path)

    def _load_model_tree(self, tree) -> None:
        """A ``model`` tree (JAX layout) into the modules, which write it
        into the flat buffer they view."""
        cfg = self.cfg
        load_jax_params(tree, cnn=cfg.cnn, transformer=cfg.transformer,
                        seq_lin=cfg.seq_lin, ctc_lin=cfg.ctc_lin,
                        settings=cfg.transformer)

    def load_from_checkpoint(self, ckpt) -> None:
        state, dev = self.state, self.device
        names = ckpt.names()
        self._load_model_tree(ckpt.load("model"))
        if "opt_torch" in names and self.tx is not None:
            self._load_opt_tree(ckpt.load("opt_torch"))
        elif "opt" in names and self.tx is not None:
            self._load_optax_tree(ckpt.load("opt"), ckpt.path)
        elif self.tx is not None:
            logger.warning("%s holds no optimizer state: Adam's "
                           "moments restart", ckpt.path)
        if "normalizer" in names:
            raw = ckpt.load("normalizer")
            state.cmvn = CmvnState(*(torch.from_numpy(np.array(
                raw[k], np.float32)).to(dev) for k in ("mean", "std",
                                                        "count")))
        counters = ckpt.load("counters") if "counters" in names else {}
        state.optimizer_step = int(counters.get("optimizer_step", 0))
        state.micro_step = int(counters.get("micro_step", 0))
        epoch_counter = self.hparams.get("epoch_counter")
        inside = ckpt.meta.get("preempted") or ckpt.meta.get("timed")
        if epoch_counter is not None and "epoch" in counters:
            epoch_counter.current = int(counters["epoch"]) - bool(inside)
        self._resume_inside = ((int(counters["epoch"]),
                                ckpt.meta.get("epoch_losses", []))
                               if inside and "epoch" in counters else None)

    def _load_opt_tree(self, raw) -> None:
        st, dev = self.state.opt_state, self.device

        def t(x):
            return torch.from_numpy(np.array(x)).to(dev)

        if np.asarray(raw["mu"]).size != self.state.params.numel:
            logger.warning("opt_torch holds %d moments for %d parameters: "
                           "Adam's moments restart",
                           np.asarray(raw["mu"]).size,
                           self.state.params.numel)
            return
        st.mu, st.nu = t(raw["mu"]), t(raw["nu"])
        st.count, st.notfinite = t(raw["count"]), t(raw["notfinite"])
        st.sched_count = int(raw["sched_count"])
        st.mini_step = int(raw["mini_step"])
        st.acc = t(raw["acc"]) if "acc" in raw else None
        if "total_notfinite" in raw:
            st.total_notfinite = t(raw["total_notfinite"])
        self.generator.set_state(torch.from_numpy(np.array(raw["generator"])))

    def _chain(self) -> Dict[str, Any]:
        tx = self.tx
        return dict(kind=tx.kind, clip=bool(tx.max_grad_norm),
                    patience=tx.patience, accum=tx.accum)

    @torch.no_grad()
    def _as_jax_tree(self, vec: torch.Tensor) -> Dict[str, Any]:
        """A flat vector in the parameters' order as a tree in their
        JAX layout (the parameters' own mapping, through their buffer)."""
        flat = self.state.params.flat
        saved = flat.clone()
        flat.copy_(vec)
        try:
            cfg = self.cfg
            return to_jax_params(cfg.cnn, cfg.transformer, cfg.seq_lin,
                                 cfg.ctc_lin)
        finally:
            flat.copy_(saved)

    @torch.no_grad()
    def _as_flat(self, tree) -> torch.Tensor:
        """The inverse of ``_as_jax_tree``."""
        flat = self.state.params.flat
        saved = flat.clone()
        try:
            self._load_model_tree(tree)
            return flat.clone()
        finally:
            flat.copy_(saved)

    def _load_optax_tree(self, raw, path: str) -> None:
        """The JAX trainer's ``opt`` tree (optax layout) into the port's
        optimizer state."""
        st, dev = self.state.opt_state, self.device
        try:
            f = optax_opt_fields(raw, **self._chain())
            mu, nu = self._as_flat(f["mu"]), self._as_flat(f["nu"])
            acc = None if f["acc"] is None else self._as_flat(f["acc"])
        except (KeyError, ValueError, TypeError) as err:
            logger.warning("%s: its optax state is another chain's (%s): "
                           "Adam's moments restart", path, err)
            return
        st.mu, st.nu, st.acc = mu, nu, acc
        st.count = torch.tensor(float(f["count"]), device=dev)
        st.notfinite = torch.tensor(f["notfinite"], device=dev)
        st.total_notfinite = torch.tensor(f["total_notfinite"], device=dev)
        st.sched_count, st.mini_step = f["sched_count"], f["mini_step"]

    def _optax_tree(self) -> Dict[str, Any]:
        """The optimizer state in the JAX trainer's ``opt`` layout."""
        st = self.state.opt_state
        return optax_opt_tree(
            self._as_jax_tree(st.mu), self._as_jax_tree(st.nu),
            count=int(st.count), sched_count=st.sched_count,
            notfinite=int(st.notfinite),
            total_notfinite=int(st.total_notfinite),
            mini_step=st.mini_step,
            acc=None if st.acc is None else self._as_jax_tree(st.acc),
            **self._chain())

    def _cleanup_timed_checkpoints(self, keep: int = 1) -> None:
        """Keep only the newest `keep` timed checkpoints (ACC-keyed saves
        are managed separately by save_and_keep_only)."""
        timed = [c for c in self.checkpointer.list_checkpoints()
                 if c.meta.get("timed")]
        timed.sort(key=lambda c: c.meta.get("unixtime", 0), reverse=True)
        for old in timed[keep:]:
            shutil.rmtree(old.path, ignore_errors=True)

    def _checkpoint_trees(self, epoch: int) -> Dict[str, Any]:
        """Host copies of the state (the copies wait for the step in
        flight)."""
        state, cfg = self.state, self.cfg
        trees: Dict[str, Any] = {
            "model": to_jax_params(cfg.cnn, cfg.transformer, cfg.seq_lin,
                                   cfg.ctc_lin),
            "normalizer": {"mean": state.cmvn.mean, "std": state.cmvn.std,
                           "count": state.cmvn.count},
            "counters": {"optimizer_step": int(state.optimizer_step),
                         "micro_step": int(state.micro_step),
                         "epoch": int(epoch)},
        }
        st = state.opt_state
        if st is not None:
            opt = {"mu": st.mu, "nu": st.nu, "count": st.count,
                   "notfinite": st.notfinite,
                   "total_notfinite": st.total_notfinite,
                   "sched_count": st.sched_count,
                   "mini_step": st.mini_step,
                   "generator": self.generator.get_state()}
            if st.acc is not None:
                opt["acc"] = st.acc
            trees["opt_torch"] = opt
            trees["opt"] = self._optax_tree()
        return trees

    # --------------------------------------------------------------- batches
    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        sig = batch.sig.data
        if self._transfer_int16 and sig.dtype == np.float32:
            # ship PCM16 and unpack on the device: half the bytes, and
            # exact for 16-bit source audio (round(x·32768) inverts /32768);
            # audio resampled on the host (8 kHz files, host speed
            # perturbation) is not such audio and is rounded here
            sig = np.clip(np.rint(sig * 32768.0), -32768, 32767).astype(
                np.int16)
        arrays = {
            "sig": sig,
            "sig_len": batch.sig.lengths,
            "tokens": batch.tokens.data,
            "tokens_len": batch.tokens.lengths,
            "tokens_bos": batch.tokens_bos.data,
            "tokens_eos": batch.tokens_eos.data,
            "tokens_eos_len": batch.tokens_eos.lengths,
        }
        extras = getattr(batch, "extras", {})
        if "speed_idx" in extras:
            arrays["speed_idx"] = np.asarray(extras["speed_idx"], np.int64)
        if self.dp is not None:
            # zero-length rows pad the batch to the world size; this rank
            # ships its block (the block the loader's set_shard decoded)
            arrays = pad_batch_rows(arrays, self._row_multiple)
            lo, hi = process_row_block(len(arrays["sig"]), self._row_multiple,
                                       self.dp.rank, self.dp.world)
            arrays = {k: v[lo:hi] for k, v in arrays.items()}
        out = {}
        for key, value in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if t.dtype in (torch.int32, torch.int64) and key.startswith("tok"):
                t = t.long()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    # ------------------------------------------------------------------- fit
    def fit(self, epoch_counter, train_set, valid_set=None,
            train_loader_kwargs=None, valid_loader_kwargs=None,
            progress_every: int = 50) -> None:
        """Train over ``train_set`` (a ``BatchLoader`` or any iterable of
        ``PaddedBatch``; ``set_epoch(epoch)`` is called where it has one,
        and a ``BatchLoader`` passes it on to its sampler and dataset) for
        each epoch of ``epoch_counter`` (an ``EpochCounter`` or any
        iterable of epoch numbers), validating on ``valid_set`` after each.
        The loader keyword arguments are accepted as the JAX trainer takes
        them and unused (the loaders are built by the caller)."""
        # resume (if the checkpointer has a checkpoint) before the epoch
        # counter is read
        self.ensure_state()
        timer = StepTimer(device=self.device)
        self.preempted = False

        def _on_sigterm(signum, frame):
            logger.warning("SIGTERM received - checkpointing and stopping")
            self.preempted = True
            if callable(prev_handler):
                prev_handler(signum, frame)

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not in the main thread
            prev_handler = None
        try:
            self._fit_epochs(epoch_counter, train_set, valid_set, timer,
                             progress_every)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _save_inside_epoch(self, kind: str, epoch: int,
                           losses: List[torch.Tensor]) -> None:
        """A ``preempted`` or ``timed`` checkpoint, with the losses of the
        batches this epoch has trained (rank 0 writes it)."""
        if is_main_process():
            self.checkpointer.save_checkpoint(
                meta={kind: True, "epoch": epoch, "epoch_losses":
                      torch.stack(losses).float().cpu().tolist()},
                trees=self._checkpoint_trees(epoch))

    def _save_preemption_checkpoint(self, epoch: int,
                                    losses: List[torch.Tensor]) -> None:
        if self.checkpointer is not None:
            self._save_inside_epoch("preempted", epoch, losses)
            barrier()
        logger.warning("stopped by SIGTERM at epoch %d opt step %d "
                       "(checkpoint saved)", epoch,
                       self.state.optimizer_step)

    def _flag_read(self, pending: deque) -> bool:
        work, flag = pending.popleft()
        work.wait()
        return float(flag) > 0.0

    def _preemption_stop(self, pending: deque) -> bool:
        """The stop decision after a step: one process reads its own
        flag; ranks dispatch an all-reduce of their flags and read the one
        dispatched a step earlier, so all read the same sum after the same
        step."""
        if self.dp is None:
            return self.preempted
        flag = torch.full((1,), float(self.preempted), device=self.device)
        pending.append((self.dp.sum_async(flag), flag))
        return len(pending) >= 2 and self._flag_read(pending)

    def _drain_preempt_flags(self, pending: deque) -> bool:
        """The epoch's end: every flag still in flight is read."""
        if self.dp is None:
            return self.preempted
        stop = False
        while pending:
            stop = self._flag_read(pending) or stop
        return stop

    def _fit_epochs(self, epoch_counter, train_set, valid_set, timer,
                    progress_every) -> None:
        ckpt_interval = float(
            self.hparams.get("ckpt_interval_minutes", 0) or 0) * 60.0
        last_timed_ckpt = time.time()
        pending: deque = deque()
        for epoch in epoch_counter:
            t_epoch = time.time()
            if hasattr(train_set, "set_epoch"):
                train_set.set_epoch(epoch)
            update_cmvn = (self.normalize is not None
                           and self.normalize.should_update(epoch))
            losses: List[torch.Tensor] = []
            if self._resume_inside and self._resume_inside[0] == epoch:
                losses = [torch.tensor(x, dtype=torch.float32,
                                       device=self.device)
                          for x in self._resume_inside[1]]
                logger.info("epoch %d: %d batches trained before the "
                            "checkpoint are skipped", epoch, len(losses))
            self._resume_inside = None
            done = len(losses)
            self.epoch_losses = losses
            for i, batch in enumerate(train_set):
                if self.debug and i >= self.debug_batches:
                    break
                if i < done:  # trained before the checkpoint
                    continue
                dev_batch = self._device_batch(batch)
                self.state, metrics = self.train_step(
                    self.state, dev_batch, self.next_seed(),
                    update_cmvn=update_cmvn)
                losses.append(metrics["loss"])
                timer.tick(items=float(np.sum(batch.duration)))
                if self._preemption_stop(pending):
                    self.preempted = True
                    self._save_preemption_checkpoint(epoch, losses)
                    return
                if progress_every and (i + 1) % progress_every == 0:
                    stats = timer.stats()
                    logger.info(
                        "epoch %d batch %d loss %.4f (opt step %d, "
                        "%.1f steps/s, %.0f audio-s/s)", epoch, i + 1,
                        float(metrics["loss"]), self.state.optimizer_step,
                        stats.get("steps_per_sec", 0.0),
                        stats.get("items_per_sec", 0.0))
                # timed intra-epoch checkpoints (ckpt_interval_minutes),
                # rank 0 alone and with no barrier, as the JAX trainer
                if (ckpt_interval > 0 and self.checkpointer is not None
                        and is_main_process()
                        and time.time() - last_timed_ckpt > ckpt_interval):
                    self._save_inside_epoch("timed", epoch, losses)
                    self._cleanup_timed_checkpoints()
                    last_timed_ckpt = time.time()
            if self._drain_preempt_flags(pending):
                self.preempted = True
                self._save_preemption_checkpoint(epoch, losses)
                return
            if not losses:
                logger.warning("epoch %d: empty train loader", epoch)
                continue
            train_loss = float(torch.stack(losses).float().mean())
            self.train_stats = {"loss": train_loss}

            stage_stats: Dict[str, Any] = {"loss": train_loss}
            if valid_set is not None:
                stage_stats = self._validate(valid_set, epoch)
            self.last_valid_stats = stage_stats
            self._on_valid_end(epoch, stage_stats, time.time() - t_epoch)
            if self.state.optimizer_step >= self.optimizer_step_limit:
                logger.info("optimizer_step_limit %d reached - stopping",
                            self.optimizer_step_limit)
                break
            if self.debug and epoch >= int(self.run_opts.get("debug_epochs",
                                                             2)):
                break

    # ------------------------------------------------------------ validation
    def _lang_id(self, lang: str) -> int:
        tokenizer = self.hparams["tokenizer"]
        return tokenizer.encode_as_ids(f"[{lang}]")[-1]

    def _run_search(self, searcher, enc_out, wav_lens, src: str, tgt: str):
        searcher.set_decoder_prefix_tokens(self._lang_id(src),
                                           self._lang_id(tgt))
        hyps, _scores = searcher(enc_out, wav_lens)
        return hyps

    def _global_rows(self, *hyps, n: int):
        """Each rank's hypotheses gathered in global row order (one
        all-gather), cut to the batch's ``n`` rows; one list per argument."""
        if self.dp is None:
            return hyps if len(hyps) > 1 else hyps[0]
        rows = gather_to_host(list(zip(*hyps)))[:n]
        out = tuple([r[i] for r in rows] for i in range(len(hyps)))
        return out if len(hyps) > 1 else out[0]

    def _reduce_acc(self, acc) -> None:
        """ACC's counts summed over ranks."""
        if self.dp is not None and acc is not None:
            t = self.dp.sum(torch.tensor([acc.correct, acc.total],
                                         dtype=torch.float64,
                                         device=self.device))
            acc.correct, acc.total = float(t[0]), float(t[1])

    # Fused dual decode (one search over both prompts) while the fused row
    # count 2·B·beam stays small, else two searches over the same enc_out
    # (the JAX trainer's threshold; exact either way).
    DUAL_FUSE_MAX_ROWS = 80

    def _run_search_dual(self, searcher, enc_out, wav_lens, src: str,
                         tgt: str):
        """ASR + ST hypotheses off one encoder output."""
        rows = 2 * int(enc_out.shape[0]) * searcher.config.beam_size
        if rows > self.DUAL_FUSE_MAX_ROWS:
            return (self._run_search(searcher, enc_out, wav_lens, src, src),
                    self._run_search(searcher, enc_out, wav_lens, src, tgt))
        s_id, t_id = self._lang_id(src), self._lang_id(tgt)
        bos = searcher.bos_token
        (asr, _), (st, _) = searcher.call_multi(
            enc_out, wav_lens, prompts=[[bos, s_id, s_id], [bos, s_id, t_id]])
        return asr, st

    def _validate(self, valid_set, epoch: int) -> Dict[str, Any]:
        h = self.hparams
        acc = h["acc_computer"]() if "acc_computer" in h else None
        do_search = ("valid_search" in h
                     and epoch % int(h.get("valid_search_interval", 10)) == 0)
        bleu = h["bleu_computer"]() if do_search else None
        wer = h["error_rate_computer"]() if do_search else None
        bleu_nt = h["bleu_computer"]() if do_search else None
        wer_nt = h["error_rate_computer"]() if do_search else None
        special = {"[turn]": h.get("turn", 7), "[xt]": h.get("xt", 8)}
        self.ensure_state()

        losses = []
        self.valid_search_s = 0.0
        for i, batch in enumerate(valid_set):
            if self.debug and i >= self.debug_batches:
                break
            dev_batch = self._device_batch(batch)
            p_ctc, p_seq, enc_out = self.eval_forward(
                self.state.params, self.state.cmvn, dev_batch)
            loss, _ = objectives(p_ctc, p_seq, dev_batch, self.cfg)
            losses.append(loss.detach().float())
            if acc is not None:
                acc.append(p_seq, dev_batch["tokens_eos"],
                           dev_batch["tokens_eos_len"])
            if do_search:
                t0 = time.perf_counter()
                hyps_asr, hyps_st = self._global_rows(*self._run_search_dual(
                    h["valid_search"], enc_out, dev_batch["sig_len"],
                    batch.source_lang[0], batch.target_lang[0]),
                    n=len(batch.id))
                self.valid_search_s += time.perf_counter() - t0
                self._append_dual_metrics(batch, hyps_st, hyps_asr, bleu,
                                          wer, bleu_nt, wer_nt, special)

        if losses:  # each rank's shares of the batches' losses, summed
            losses = global_metrics({"l": torch.stack(losses)},
                                    self.dp)["l"].tolist()
        self._reduce_acc(acc)
        stats: Dict[str, Any] = {"loss": float(np.mean(losses or [0.0]))}
        if acc is not None:
            stats["ACC"] = acc.summarize()
        if do_search and bleu is not None and bleu.ids:
            stats["BLEU"] = bleu.summarize("BLEU")
            stats["BLEU_no_turn"] = bleu_nt.summarize("BLEU")
        if do_search and wer is not None and wer.ids:
            stats["WER"] = wer.summarize("error_rate")
            stats["WER_no_turn"] = wer_nt.summarize("error_rate")
        return stats

    def _append_dual_metrics(self, batch, hyps_st, hyps_asr, bleu, wer,
                             bleu_nt, wer_nt, special) -> None:
        tokenizer = self.hparams["tokenizer"]
        tgt_lang = batch.target_lang[0]
        # ST stream vs translation_0
        refs_st = batch.extras.get("translation_0")
        if refs_st and refs_st[0] is not None:
            ids, tgts, preds = append_gt_preds(
                batch.id, refs_st, hyps_st, tgt_lang, tokenizer)
            bleu.append(ids, preds, [tgts])
            ids, tgts, preds = append_gt_preds(
                batch.id, refs_st, hyps_st, tgt_lang, tokenizer,
                remove_special_chars=True, chars_dict=special)
            bleu_nt.append(ids, preds, [tgts])
        # ASR stream vs transcription (WER on space-split words)
        refs_asr = batch.extras.get("transcription")
        if refs_asr and refs_asr[0] is not None:
            ids, tgts, preds = append_gt_preds(
                batch.id, refs_asr, hyps_asr, tgt_lang, tokenizer)
            wer.append(ids, [p.split(" ") for p in preds],
                       [t.split(" ") for t in tgts])
            ids, tgts, preds = append_gt_preds(
                batch.id, refs_asr, hyps_asr, tgt_lang, tokenizer,
                remove_special_chars=True, chars_dict=special)
            wer_nt.append(ids, [p.split(" ") for p in preds],
                          [t.split(" ") for t in tgts])

    def _on_valid_end(self, epoch: int, stage_stats: Dict[str, Any],
                      epoch_time: float) -> None:
        h = self.hparams
        scheduler = h.get("lr_scheduler")
        # lr the NEXT attempt will run at (attempt a runs at value(a-1),
        # the first at the optimizer construction lr)
        step = int(self.state.optimizer_step)
        lr = (float(scheduler.value(step)) if scheduler is not None
              and step >= 1 else float(h.get("lr_adam", 0.0)))
        if "train_logger" in h and is_main_process():
            h["train_logger"].log_stats(
                stats_meta={"epoch": epoch, "lr": lr, "steps": step,
                            "optimizer": "AdamW",
                            "epoch_time": round(epoch_time, 1)},
                train_stats=self.train_stats, valid_stats=stage_stats)
        if self.checkpointer is not None and "ACC" in stage_stats:
            if is_main_process():
                self.checkpointer.save_and_keep_only(
                    meta={"ACC": float(stage_stats["ACC"]), "epoch": epoch},
                    trees=self._checkpoint_trees(epoch), max_keys=["ACC"],
                    num_to_keep=5)
            barrier()

    # ------------------------------------------------------------ evaluation
    def on_evaluate_start(self, max_key: str = "ACC") -> None:
        """Load the average of the kept top-k checkpoints as the weights
        (reference ``on_evaluate_start``, ``train_multitask.py:460-471``)."""
        if self.checkpointer is None or self.state is None:
            return
        ckpts = self.checkpointer.find_checkpoints(max_key=max_key)
        if not ckpts:
            return
        self._load_model_tree(average_checkpoints(ckpts, "model"))
        logger.info("Loaded the average of %d checkpoints", len(ckpts))

    def evaluate(self, test_set, test_loader_kwargs=None,
                 average_first: bool = True) -> Dict[str, Any]:
        """Single-task test evaluation (reference ``__main__`` test loop,
        ``train_multitask.py:694-726``)."""
        h = self.hparams
        self.ensure_state()
        if average_first:
            self.on_evaluate_start()
        searcher = h["test_search"]
        acc = h["acc_computer"]() if "acc_computer" in h else None
        bleu = h["bleu_computer"]()
        wer = h["error_rate_computer"]()
        bleu_nt = h["bleu_computer"]()
        wer_nt = h["error_rate_computer"]()
        special = {"[turn]": h.get("turn", 7), "[xt]": h.get("xt", 8)}
        tokenizer = h["tokenizer"]

        task = None
        for batch in test_set:
            dev_batch = self._device_batch(batch)
            if task is None:
                task = batch.task[0]
            if len(set(batch.task)) != 1:
                raise AssertionError(
                    "test sets carry exactly one task per JSON "
                    "(train_multitask.py:115-117)")
            p_ctc, p_seq, enc_out = self.eval_forward(
                self.state.params, self.state.cmvn, dev_batch)
            if acc is not None:
                acc.append(p_seq, dev_batch["tokens_eos"],
                           dev_batch["tokens_eos_len"])
            src, tgt = batch.source_lang[0], batch.target_lang[0]
            if task == "transcription":
                hyps = self._global_rows(self._run_search(
                    searcher, enc_out, dev_batch["sig_len"], src, src),
                    n=len(batch.id))
                refs = batch.extras.get("transcription")
                ids, tgts, preds = append_gt_preds(batch.id, refs, hyps, src,
                                                   tokenizer)
                wer.append(ids, [p.split(" ") for p in preds],
                           [t.split(" ") for t in tgts])
                ids, tgts, preds = append_gt_preds(
                    batch.id, refs, hyps, src, tokenizer,
                    remove_special_chars=True, chars_dict=special)
                wer_nt.append(ids, [p.split(" ") for p in preds],
                              [t.split(" ") for t in tgts])
            else:
                hyps = self._global_rows(self._run_search(
                    searcher, enc_out, dev_batch["sig_len"], src, tgt),
                    n=len(batch.id))
                refs = batch.extras.get("translation_0")
                has_4refs = (batch.extras.get("translation_1") is not None
                             and batch.extras["translation_1"][0] is not None)
                ids, tgts, preds = append_gt_preds(batch.id, refs, hyps, tgt,
                                                   tokenizer)
                _, tgts_nt, preds_nt = append_gt_preds(
                    batch.id, refs, hyps, tgt, tokenizer,
                    remove_special_chars=True, chars_dict=special)
                if has_4refs:
                    four = [batch.extras.get(f"translation_{k}")
                            for k in range(4)]
                    targets, targets_nt = append_4gt(four, tgt, special)
                    bleu.append(ids, preds, targets)
                    bleu_nt.append(ids, preds_nt, targets_nt)
                else:
                    bleu.append(ids, preds, [tgts])
                    bleu_nt.append(ids, preds_nt, [tgts_nt])

        self._reduce_acc(acc)
        stats: Dict[str, Any] = {}
        if acc is not None and acc.total > 0:
            stats["ACC"] = acc.summarize()
        write = is_main_process()  # every rank holds the metrics; one writes
        if wer.ids:
            stats["WER"] = wer.summarize("error_rate")
            stats["WER_no_turn"] = wer_nt.summarize("error_rate")
            if h.get("wer_file") and write:
                print_bleu_or_wer(wer, h["wer_file"], logger)
            if h.get("wer_file_no_turn") and write:
                print_bleu_or_wer(wer_nt, h["wer_file_no_turn"], logger)
        if bleu.ids:
            stats["BLEU"] = bleu.summarize("BLEU")
            stats["BLEU_no_turn"] = bleu_nt.summarize("BLEU")
            if h.get("bleu_file") and write:
                print_bleu_or_wer(bleu, h["bleu_file"], logger, is_bleu=True)
            if h.get("bleu_file_no_turn") and write:
                print_bleu_or_wer(bleu_nt, h["bleu_file_no_turn"], logger,
                                  is_bleu=True)
        barrier()
        if "train_logger" in h and write:
            counter = h.get("epoch_counter")
            h["train_logger"].log_stats(
                stats_meta={"Epoch loaded": int(counter.current
                                                if counter else 0)},
                test_stats=stats)
        return stats
