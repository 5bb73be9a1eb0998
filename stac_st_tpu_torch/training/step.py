"""The train and eval steps (port of ``stac_st_tpu/training/step.py``).

One training step:

  PCM16/float audio -> device speed perturbation (when configured and
  the batch has a speed_idx column) -> fbank -> CMVN (running-stats
  update when asked) -> SpecAugment -> conv front end (dropout) ->
  teacher-forced encoder-decoder (dropout; key-padding attention through
  the ``flash_attention_train`` kernels) -> CTC + label-smoothed NLL ->
  backward -> the optimizer chain.

Semantics kept from the reference:

* loss = ctc_weight · CTC + (1 − ctc_weight) · NLL(label smoothing);
* mixed precision is a cast of every float parameter and of the features
  to the compute dtype (fbank, CMVN, SpecAugment and both losses stay
  fp32, the master weights and the optimizer too); the cast is part of
  the autograd graph, so gradients arrive in fp32;
* the optimizer chain of ``make_optimizer`` (see there).

PyTorch idiom: the parameters of the four modules live as views of ONE
fp32 buffer (:class:`FlatParams`); each step differentiates a detached
alias of that buffer through ``torch.func.functional_call``, so the
gradient arrives as one flat tensor, and the optimizer updates the buffer
in place (the modules see the new weights; nothing is copied). The step
mutates and returns its :class:`TrainState`. Its randomness comes from
one integer seed per call (:class:`~..models.dropout.StepRandom`).

Data parallelism (``StepConfig.dp``, a
:class:`~..parallel.distributed.DataParallel`): each rank holds an equal
row block of the padded global batch, and its step computes what the
whole batch computes on one device. The couplings across rows are made
global: the fbank ``top_db`` max (an all-reduce MAX), the CMVN update's
sums and row count, SpecAugment's draws and fill mean, the dropout draws
(keyed to global rows), and the losses' normalizers (global row and token
counts, padding rows included, as the JAX mesh step counts them), so the
ranks' losses are shares that sum to the global loss. The flat fp32
gradient is summed over ranks in ONE all-reduce of the ``FlatParams``
buffer's gradient per microbatch, before the optimizer, so the finite
flag and the clip norm (and every update) are the same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..models.dropout import StepRandom
from ..ops.cmvn import CmvnState, cmvn_apply, cmvn_init, cmvn_update
from ..ops.ctc import ctc_loss
from ..ops.losses import length_mask, nll_loss
from ..ops.specaugment import spec_augment
from .optim import OptimizerFactory

__all__ = ["TrainState", "StepConfig", "FlatParams", "OptState",
           "ChainOptimizer", "make_optimizer", "init_train_state",
           "make_train_step", "make_eval_forward", "make_encode_forward",
           "loss_and_grad", "global_metrics"]

MODULE_KEYS = ("CNN", "Transformer", "seq_lin", "ctc_lin")


class StepConfig(NamedTuple):
    fbank: Any                 # ops.fbank.Fbank
    cnn: nn.Module
    transformer: nn.Module
    seq_lin: nn.Module
    ctc_lin: nn.Module
    specaug_opts: Optional[Tuple[Tuple[str, Any], ...]]
    ctc_weight: float
    label_smoothing: float
    loss_reduction: str
    pad_index: int
    blank_index: int
    #: network compute dtype (None = fp32), e.g. torch.bfloat16
    compute_dtype: Optional[torch.dtype] = None
    #: optional ops.speed_perturb.DeviceSpeedPerturb: resample on the
    #: device in training when the batch carries a speed_idx column
    device_speed: Any = None
    #: parallel.distributed.DataParallel of a multi-rank run, else None
    dp: Any = None

    def modules(self) -> Dict[str, nn.Module]:
        return dict(zip(MODULE_KEYS, (self.cnn, self.transformer,
                                      self.seq_lin, self.ctc_lin)))


class FlatParams:
    """The float parameters of several modules as views of one fp32
    buffer ``flat``. A module shared under two keys is stored once."""

    def __init__(self, modules: Dict[str, nn.Module], device):
        self.modules = modules
        self.slots: Dict[int, Tuple[int, torch.Size]] = {}  # id -> (off, shape)
        self.names: Dict[str, Dict[str, int]] = {}          # key -> name -> id
        params = []
        for key, mod in modules.items():
            mod.to(device=device, dtype=torch.float32)
            self.names[key] = {}
            for name, p in mod.named_parameters():
                if id(p) not in self.slots:
                    off = sum(q.numel() for q in params)
                    self.slots[id(p)] = (off, p.shape)
                    params.append(p)
                self.names[key][name] = id(p)
        self.numel = sum(p.numel() for p in params)
        self.order = [id(p) for p in params]  # storage order
        self.sizes = [p.numel() for p in params]
        self.flat = torch.empty(self.numel, dtype=torch.float32,
                                device=device)
        for p in params:
            off, shape = self.slots[id(p)]
            view = self.flat[off:off + p.numel()].view(shape)
            view.copy_(p.detach())
            p.data = view  # the module now reads the buffer

    def views(self, flat: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per module key, its parameters as (differentiable) views of
        ``flat`` (the buffer, a detached alias of it, or a cast). One
        ``split`` makes them all, so the backward assembles the flat
        gradient in one concatenation (slicing each view apart would
        zero-fill and add a whole flat gradient per parameter)."""
        pieces = dict(zip(self.order, flat.split(self.sizes)))
        return {key: {name: pieces[i].view(self.slots[i][1])
                      for name, i in names.items()}
                for key, names in self.names.items()}

    def named(self, flat: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """``{"CNN.layers.block0_conv0.weight": tensor, ...}``."""
        views = self.views(self.flat if flat is None else flat)
        return {f"{key}.{name}": t for key, d in views.items()
                for name, t in d.items()}


@dataclass
class OptState:
    mu: torch.Tensor              # Adam first moment (flat, fp32)
    nu: torch.Tensor              # Adam second moment
    count: torch.Tensor           # () fp32 on device: updates applied
    notfinite: torch.Tensor       # () int64 on device: consecutive skips
    sched_count: int = 0          # attempts so far (applied or skipped)
    acc: Optional[torch.Tensor] = None  # accumulated gradient mean
    mini_step: int = 0
    total_notfinite: Optional[torch.Tensor] = None  # () int64: all skips


class ChainOptimizer:
    """The reference's optax chain (``make_optimizer``), on flat tensors:

    MultiSteps(accumulate k microbatches, running mean)
      -> apply_if_finite(clip_by_global_norm? -> adam(w) at lr 1)
      -> scale_by_schedule(lr(attempt)).

    Every decision the device makes (finite or not) stays on the device:
    the update is selected with ``torch.where``, so a step never waits for
    the card."""

    def __init__(self, factory: OptimizerFactory, schedule_value: Callable,
                 grad_accumulation_factor: int = 1,
                 max_grad_norm: Optional[float] = None,
                 nonfinite_patience: int = 100):
        self.kind = factory.kind
        self.first_lr = float(factory.lr)
        self.b1, self.b2 = factory.betas
        self.eps = factory.eps
        self.weight_decay = factory.weight_decay
        self.schedule_value = schedule_value
        self.accum = int(grad_accumulation_factor)
        self.max_grad_norm = max_grad_norm
        self.patience = int(nonfinite_patience)

    def lr_at(self, attempts: int) -> float:
        """Attempt 1 runs at the construction lr, attempt a >= 2 at
        value(a − 1) (the reference steps its scheduler after the update)."""
        if attempts == 0:
            return self.first_lr
        return float(self.schedule_value(attempts))

    def init(self, flat: torch.Tensor) -> OptState:
        dev = flat.device
        return OptState(
            mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
            count=torch.zeros((), dtype=torch.float32, device=dev),
            notfinite=torch.zeros((), dtype=torch.int64, device=dev),
            acc=torch.zeros_like(flat) if self.accum > 1 else None,
            total_notfinite=torch.zeros((), dtype=torch.int64, device=dev))

    @torch.no_grad()
    def update(self, grad: torch.Tensor, st: OptState,
               flat: torch.Tensor) -> int:
        """Fold one microbatch gradient in; at a group boundary update
        ``flat`` in place (or leave it, if the group was not finite).
        Returns 1 when this call was an update attempt, else 0."""
        g = grad
        if self.accum > 1:
            acc = st.acc + (grad - st.acc) / (st.mini_step + 1)
            if st.mini_step < self.accum - 1:
                st.acc, st.mini_step = acc, st.mini_step + 1
                return 0
            # optax resets with (1 - emit) * acc: a NaN stays NaN
            st.acc, st.mini_step, g = acc * 0.0, 0, acc
        if self.patience:
            finite = torch.isfinite(g).all()
            st.notfinite = torch.where(finite, 0, st.notfinite + 1)
            st.total_notfinite = st.total_notfinite + (~finite).long()
            apply = finite | (st.notfinite > self.patience)
        else:
            apply = torch.ones((), dtype=torch.bool, device=flat.device)
        if self.max_grad_norm:
            norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.max_grad_norm, g,
                            g / norm * self.max_grad_norm)
        count = st.count + 1.0
        mu = (1.0 - self.b1) * g + self.b1 * st.mu
        nu = (1.0 - self.b2) * (g * g) + self.b2 * st.nu
        mu_hat = mu / (1.0 - torch.pow(self.b1, count))
        nu_hat = nu / (1.0 - torch.pow(self.b2, count))
        u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        if self.kind == "adamw":
            u = u + self.weight_decay * flat
        lr = self.lr_at(st.sched_count)
        st.sched_count += 1
        flat.copy_(torch.where(apply, flat + (-u) * lr, flat))
        st.mu = torch.where(apply, mu, st.mu)
        st.nu = torch.where(apply, nu, st.nu)
        st.count = torch.where(apply, count, st.count)
        return 1


def make_optimizer(opt_factory, schedule_value: Callable,
                   grad_accumulation_factor: int = 1,
                   max_grad_norm: Optional[float] = None,
                   nonfinite_patience: int = 100) -> ChainOptimizer:
    """The reference's update chain. Attempt ``a`` (1-based, counting
    accumulation boundaries) runs at ``value(a − 1)`` and the first at the
    optimizer's construction lr; skipped attempts still advance the
    schedule; Adam's moments never take a nonfinite gradient (until
    ``nonfinite_patience`` consecutive skips, as optax's
    ``apply_if_finite``); a nonfinite microbatch anywhere in an
    accumulation group skips the whole group; clipping only when
    ``max_grad_norm`` is given."""
    if not isinstance(opt_factory, OptimizerFactory) and callable(
            opt_factory):
        opt_factory = opt_factory()
    return ChainOptimizer(opt_factory, schedule_value,
                          grad_accumulation_factor, max_grad_norm,
                          nonfinite_patience)


@dataclass
class TrainState:
    params: FlatParams
    opt_state: Optional[OptState]
    cmvn: CmvnState
    optimizer_step: int = 0   # update attempts, skipped ones included
    micro_step: int = 0       # train_step calls


def init_train_state(cfg: StepConfig, tx: Optional[ChainOptimizer],
                     device=None, n_mels: int = 80) -> TrainState:
    """Move the config's modules to ``device`` (default ``cuda``) in fp32,
    alias their parameters into one buffer, and start the optimizer (none
    for an eval-only ``tx=None``) and CMVN state. The weights are those
    the modules hold (seeded init or ``interop.from_jax.load_jax_params``).
    """
    dev = resolve_device(device)
    params = FlatParams(cfg.modules(), dev)
    return TrainState(params=params,
                      opt_state=tx.init(params.flat) if tx is not None
                      else None,
                      cmvn=cmvn_init(n_mels, dev))


def _forward(params: FlatParams, flat: torch.Tensor, cmvn: CmvnState,
             batch: Dict[str, torch.Tensor], cfg: StepConfig, train: bool,
             update_cmvn: bool, rng: Optional[StepRandom]):
    wavs, wav_lens = batch["sig"], batch["sig_len"]
    if wavs.dtype == torch.int16:
        wavs = wavs.to(torch.float32) / 32768.0  # exact inverse of the pack
    if cfg.device_speed is not None and train and "speed_idx" in batch:
        # the losses keep the batch's own sig_len, as the JAX step does
        wavs, wav_lens = cfg.device_speed.apply(wavs, wav_lens,
                                                batch["speed_idx"])
    dp = cfg.dp
    if dp is None:
        feats = cfg.fbank(wavs)
        if update_cmvn:
            cmvn = cmvn_update(cmvn, feats, wav_lens)
    else:
        feats = cfg.fbank(wavs, reduce_max=lambda t: dp.max(t.reshape(1))[0])
        if update_cmvn:
            cmvn = cmvn_update(cmvn, feats, wav_lens, reduce_sum=dp.sum,
                               n_rows=dp.rows(feats.shape[0])[1])
    feats = cmvn_apply(cmvn, feats)
    if train and cfg.specaug_opts is not None:
        feats = spec_augment(
            feats, rng.host, **dict(cfg.specaug_opts),
            **({} if dp is None else dict(rows=dp.rows(feats.shape[0]),
                                          reduce_sum=dp.sum)))
    if cfg.compute_dtype is not None:
        feats = feats.to(cfg.compute_dtype)
        flat = flat.to(cfg.compute_dtype)
    views = params.views(flat)

    def call(key, *args, **kwargs):
        return functional_call(params.modules[key], views[key], args, kwargs)

    src = call("CNN", feats, train=train, rng=rng)
    enc, dec = call("Transformer", src, batch["tokens_bos"], wav_lens,
                    cfg.pad_index, train=train, rng=rng)
    p_ctc = None
    if cfg.ctc_weight > 0:
        p_ctc = torch.log_softmax(call("ctc_lin", enc).float(), dim=-1)
    p_seq = torch.log_softmax(call("seq_lin", dec).float(), dim=-1)
    return p_ctc, p_seq, enc, cmvn


def objectives(p_ctc, p_seq, batch, cfg: StepConfig):
    """(loss, metrics); under ``cfg.dp`` this rank's share of the global
    batch's loss (the module note)."""
    n_rows = n_tokens = None
    if cfg.dp is not None:
        n_rows = cfg.dp.rows(p_seq.shape[0])[1]
        if cfg.label_smoothing > 0.0 or cfg.loss_reduction == "mean":
            n_tokens = cfg.dp.sum(length_mask(
                batch["tokens_eos_len"], p_seq.shape[1]).sum().reshape(1))[0]
    att = nll_loss(p_seq, batch["tokens_eos"], batch["tokens_eos_len"],
                   label_smoothing=cfg.label_smoothing,
                   reduction=cfg.loss_reduction, n_rows=n_rows,
                   n_tokens=n_tokens)
    ctc = torch.zeros((), device=p_seq.device)
    if cfg.ctc_weight > 0:
        ctc = ctc_loss(p_ctc, batch["tokens"], batch["sig_len"],
                       batch["tokens_len"], blank_index=cfg.blank_index,
                       reduction=cfg.loss_reduction, n_rows=n_rows)
    loss = cfg.ctc_weight * ctc + (1.0 - cfg.ctc_weight) * att
    return loss, {"loss": loss.detach(), "ctc_loss": ctc.detach(),
                  "att_loss": att.detach()}


def global_metrics(metrics: Dict[str, torch.Tensor], dp
                   ) -> Dict[str, torch.Tensor]:
    """The ranks' shares of each metric summed (one all-reduce)."""
    if dp is None:
        return metrics
    total = dp.sum(torch.stack([metrics[k].float() for k in metrics]))
    return dict(zip(metrics, total.unbind()))


def loss_and_grad(cfg: StepConfig, state: TrainState, batch, seed: int,
                  update_cmvn: bool = False):
    """(metrics, flat fp32 gradient, new CMVN state) of one microbatch;
    under ``cfg.dp`` the global batch's metrics and gradient."""
    w = state.params.flat.detach().requires_grad_(True)
    row0, n_rows = (0, None) if cfg.dp is None else \
        cfg.dp.rows(batch["sig"].shape[0])
    rng = StepRandom(seed, w.device, row0, n_rows)
    p_ctc, p_seq, _, cmvn = _forward(state.params, w, state.cmvn, batch, cfg,
                                     True, update_cmvn, rng)
    loss, metrics = objectives(p_ctc, p_seq, batch, cfg)
    loss.backward()
    grad = w.grad
    if cfg.dp is not None:
        cfg.dp.sum(grad)
        metrics = global_metrics(metrics, cfg.dp)
    return metrics, grad, cmvn


def make_train_step(cfg: StepConfig, tx: ChainOptimizer):
    """train_step(state, batch, seed, update_cmvn=False) -> (state, metrics).

    ``batch`` holds device tensors: sig (B, L) fp32 or int16 PCM, sig_len,
    tokens, tokens_len, tokens_bos, tokens_eos, tokens_eos_len (lengths
    relative). Updates ``state`` in place and returns it."""

    def train_step(state: TrainState, batch, seed: int,
                   update_cmvn: bool = False):
        metrics, grad, cmvn = loss_and_grad(cfg, state, batch, seed,
                                            update_cmvn)
        metrics["grad_norm"] = torch.linalg.vector_norm(grad)
        state.optimizer_step += tx.update(grad, state.opt_state,
                                          state.params.flat)
        state.cmvn = cmvn
        state.micro_step += 1
        return state, metrics

    return train_step


def make_eval_forward(cfg: StepConfig):
    """eval_forward(params, cmvn, batch) -> (p_ctc, p_seq, enc_out): the
    teacher-forced forward with training off (no dropout, no SpecAugment,
    no CMVN update; key-padding attention through ``flash_attention``)."""

    @torch.no_grad()
    def eval_forward(params: FlatParams, cmvn: CmvnState, batch):
        p_ctc, p_seq, enc, _ = _forward(params, params.flat, cmvn, batch,
                                        cfg, False, False, None)
        return p_ctc, p_seq, enc

    return eval_forward


def make_encode_forward(cfg: StepConfig):
    """encode_forward(params, cmvn, batch) -> (p_ctc, enc_out): the
    inference recipe's forward (fbank -> CMVN -> CNN -> ``encode`` with its
    floor-based mask and plain attention -> CTC head)."""

    @torch.no_grad()
    def encode_forward(params: FlatParams, cmvn: CmvnState, batch):
        feats = cmvn_apply(cmvn, cfg.fbank(batch["sig"]))
        flat = params.flat
        if cfg.compute_dtype is not None:
            feats = feats.to(cfg.compute_dtype)
            flat = flat.to(cfg.compute_dtype)
        views = params.views(flat)
        src = functional_call(params.modules["CNN"], views["CNN"], (feats,))
        tr = _Method(params.modules["Transformer"], "encode")
        enc = functional_call(
            tr, {f"module.{n}": t for n, t in views["Transformer"].items()},
            (src, batch["sig_len"]))
        p_ctc = None
        if cfg.ctc_weight > 0:
            p_ctc = torch.log_softmax(functional_call(
                params.modules["ctc_lin"], views["ctc_lin"], (enc,)).float(),
                dim=-1)
        return p_ctc, enc

    return encode_forward


class _Method(nn.Module):
    """Calls one method of a module as its forward (for functional_call)."""

    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.module, self.method = module, method

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.method)(*args, **kwargs)
