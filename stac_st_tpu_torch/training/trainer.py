"""The ST trainer, single-device core (port of
``stac_st_tpu/training/trainer.py``).

``STTrainer`` builds the step configuration from the modules and hparams
(precision, losses, SpecAugment, device speed perturbation, the optimizer
chain), creates the train state at the first batch, moves each
``PaddedBatch`` to the device (PCM16 when ``transfer_int16`` is set; the
``speed_idx`` column when the loader drew one) and runs ``fit`` over a
``data.loader.BatchLoader`` or any iterable of batches: per epoch,
``set_epoch`` (which keys the loader's shuffle and speed draw), the CMVN
update gate, one train step per batch, ``optimizer_step_limit`` and the
debug limits.

Randomness: one CPU ``torch.Generator`` per trainer, seeded from
``hparams["seed"]``; each step draws its integer seed from it.

Not ported yet: meshes and multi-device, pipeline stages, preemption
handling, checkpoints, validation with beam search, ``evaluate``, and the
``train_attn_kernel`` / ``rng_impl`` run options
(the port always takes its attention kernels).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .step import (
    StepConfig,
    TrainState,
    init_train_state,
    make_encode_forward,
    make_eval_forward,
    make_optimizer,
    make_train_step,
)

logger = logging.getLogger(__name__)

__all__ = ["STTrainer"]


def _specaug_opts(hparams) -> Optional[tuple]:
    aug = hparams.get("augmentation")
    if aug is None or not hasattr(aug, "opts"):
        return None
    return tuple(sorted(aug.opts.items()))


class STTrainer:
    """Drives training of the multitask ASR+ST model on one device."""

    def __init__(self, modules: Dict[str, Any], opt_class=None,
                 hparams: Optional[Dict[str, Any]] = None,
                 run_opts: Optional[Dict[str, Any]] = None, device=None):
        self.hparams = dict(hparams or {})
        self.run_opts = dict(run_opts or {})
        self.modules = modules
        self.device = resolve_device(device)
        h = self.hparams

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
        )
        self.normalize = modules.get("normalize")
        scheduler = h.get("lr_scheduler")
        factory = opt_class if opt_class is not None else h.get("Adam")
        self.tx = make_optimizer(
            factory,
            scheduler.value if scheduler is not None
            else (lambda step: h.get("lr_adam", 1e-3)),
            grad_accumulation_factor=int(h.get("grad_accumulation_factor",
                                               1)),
            # clipping is opt-in, as in the reference recipe
            max_grad_norm=(h.get("max_grad_norm")
                           if h.get("use_grad_clipping") else None),
            nonfinite_patience=int(h.get("nonfinite_patience", 100)),
        )
        self.train_step = make_train_step(self.cfg, self.tx)
        self.eval_forward = make_eval_forward(self.cfg)
        self.encode_forward = make_encode_forward(self.cfg)

        self.state: Optional[TrainState] = None
        self.optimizer_step_limit = int(h.get("optimizer_step_limit", 10**9))
        self._transfer_int16 = bool(self.run_opts.get("transfer_int16"))
        self.generator = torch.Generator().manual_seed(
            int(h.get("seed", 8886)))
        self.train_stats: Dict[str, float] = {}
        self.epoch_losses: List[torch.Tensor] = []  # last epoch, per step
        self.debug = bool(self.run_opts.get("debug", False))
        self.debug_batches = int(self.run_opts.get("debug_batches", 2))

    # ------------------------------------------------------------ state mgmt
    def ensure_state(self, sample_batch=None) -> TrainState:
        """The train state, created at the first call from the weights the
        modules hold."""
        if self.state is None:
            self.state = init_train_state(
                self.cfg, self.tx, self.device,
                int(self.hparams.get("n_mels", 80)))
            logger.info("initialized %d parameters", self.state.params.numel)
        return self.state

    def next_seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator))

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
        out = {}
        for key, value in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if t.dtype in (torch.int32, torch.int64) and key.startswith("tok"):
                t = t.long()
            out[key] = t.to(self.device, non_blocking=True)
        return out

    # ------------------------------------------------------------------- fit
    def fit(self, epoch_counter, train_set, progress_every: int = 50) -> None:
        """Train over ``train_set`` (a ``BatchLoader`` or any iterable of
        ``PaddedBatch``; ``set_epoch(epoch)`` is called where it has one,
        and a ``BatchLoader`` passes it on to its sampler and dataset) for
        each epoch of ``epoch_counter`` (an iterable of epoch numbers)."""
        for epoch in epoch_counter:
            if hasattr(train_set, "set_epoch"):
                train_set.set_epoch(epoch)
            update_cmvn = (self.normalize is not None
                           and self.normalize.should_update(epoch))
            losses: List[torch.Tensor] = []
            t0, audio_s = time.perf_counter(), 0.0
            for i, batch in enumerate(train_set):
                if self.debug and i >= self.debug_batches:
                    break
                dev_batch = self._device_batch(batch)
                self.ensure_state(dev_batch)
                self.state, metrics = self.train_step(
                    self.state, dev_batch, self.next_seed(),
                    update_cmvn=update_cmvn)
                losses.append(metrics["loss"])
                audio_s += float(np.sum(batch.duration))
                if progress_every and (i + 1) % progress_every == 0:
                    dt = time.perf_counter() - t0
                    logger.info(
                        "epoch %d batch %d loss %.4f (opt step %d, "
                        "%.0f audio-s/s)", epoch, i + 1,
                        float(metrics["loss"]), self.state.optimizer_step,
                        audio_s / max(dt, 1e-9))
            self.epoch_losses = losses
            if not losses:
                logger.warning("epoch %d: empty train loader", epoch)
                continue
            self.train_stats = {
                "loss": float(torch.stack(losses).float().mean())}
            if self.state.optimizer_step >= self.optimizer_step_limit:
                logger.info("optimizer_step_limit %d reached - stopping",
                            self.optimizer_step_limit)
                break
            if self.debug and epoch >= int(self.run_opts.get("debug_epochs",
                                                             2)):
                break
