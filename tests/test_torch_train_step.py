"""The port's training slice against the JAX package.

Losses, CMVN update and SpecAugment's apply part against the JAX
functions (fp32, atol 1e-5 unless stated); then the slice: the JAX
``make_train_step`` against the port's at the tiny sizes of
``tests/test_train_oracle.py`` (d32, 4 heads, 2 + 2 layers, vocab 50,
CNN (8, 8), 16 mels, B2 x 0.5 s, U8), fp32, dropout 0, accumulation 2,
clipping at 1.0, five microsteps with a NaN boundary batch, the JAX step
running its Pallas training kernels in interpret mode (built once; the
port runs their plain versions; under xdist the JAX half is built once
per run and shared through a file lock). Tolerances are
test_train_oracle's, for its reasons: per-step loss rtol 2e-5 (fp32
forward noise ~1e-6), gradients atol 2e-5 x the largest gradient with rtol
2e-3, parameters rtol 5e-3 with atol 5e-4 (per-step noise through AdamW,
whose update is ~lr per element), ``optimizer_step`` equal. The JAX XLA
path is held against the port by the eval forward (and against the Pallas
path by the JAX package's own tests). JAX steps are built once per module.
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu.models import ConvolutionFrontEnd, LinearHead
from stac_st_tpu.models import TransformerMultiTask
from stac_st_tpu.ops import Fbank as JFbank
from stac_st_tpu.ops import pallas as jpallas
from stac_st_tpu.ops.cmvn import CmvnState as JCmvn
from stac_st_tpu.ops.cmvn import cmvn_update as j_cmvn_update
from stac_st_tpu.ops.ctc import ctc_loss as j_ctc_loss
from stac_st_tpu.ops.losses import nll_loss as j_nll_loss
from stac_st_tpu.ops.specaugment import _warp_to as j_warp_to
from stac_st_tpu.training import step as jstep
from stac_st_tpu.training.optim import AdamW as JAdamW
from stac_st_tpu.training.schedulers import WarmCoolDecayLRSchedule as JSched

from stac_st_tpu_torch import models as P
from stac_st_tpu_torch.data.dataset import collate_batch
from stac_st_tpu_torch.interop.from_jax import load_jax_params
from stac_st_tpu_torch.ops.cmvn import (
    CmvnState,
    InputNormalization,
    cmvn_update,
)
from stac_st_tpu_torch.ops.ctc import ctc_loss
from stac_st_tpu_torch.ops.fbank import Fbank
from stac_st_tpu_torch.ops.losses import nll_loss
from stac_st_tpu_torch.ops.specaugment import (
    SpecAugParams,
    apply_spec_augment,
    draw_spec_augment,
    warp_to,
)
from stac_st_tpu_torch.training import step as pstep
from stac_st_tpu_torch.training.optim import AdamW
from stac_st_tpu_torch.training.schedulers import WarmCoolDecayLRSchedule
from stac_st_tpu_torch.training.trainer import STTrainer

from torch_once import built_once_all

from test_torch_model import _seeded_leaf

D, H, LAYERS, FFN, VOCAB, N_MELS, CH = 32, 4, 2, 64, 50, 16, 8
LR, CLIP, ACCUM = 5e-3, 1.0, 2
SCHED = dict(warmup=20, cooldown=10, total_steps=100, decay_factor=0.75,
             decay_every=10.0)
WAV_LEN, U = 8000, 8


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------------- losses
@pytest.mark.parametrize("reduction", ["mean", "batchmean", "batch", "sum"])
def test_nll_loss_matches_jax(reduction):
    rng = np.random.default_rng(0)
    lp = np.log(rng.dirichlet(np.ones(11), (3, 7))).astype(np.float32)
    tgt = rng.integers(0, 11, (3, 9))
    lens = np.asarray([1.0, 0.55, 0.3], np.float32)
    # one compile a smoothing value (eager, each operation compiles)
    reference = jax.jit(j_nll_loss,
                        static_argnames=("label_smoothing", "reduction"))
    for ls in (0.0, 0.1):
        want = reference(jnp.asarray(lp), jnp.asarray(tgt), jnp.asarray(lens),
                         label_smoothing=ls, reduction=reduction)
        got = nll_loss(_t(lp), _t(tgt), _t(lens), label_smoothing=ls,
                       reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-6)


def test_ctc_loss_matches_optax_including_an_infeasible_row():
    """Row 2's 6 labels cannot fit its 4 frames: optax floors the
    impossible paths and returns ~1e5, where torch's CTC gives inf.
    Values agree (rtol 1e-6), and gradients to atol 1e-5 on the feasible
    rows; on the infeasible row to atol 1e-2, because its forward
    variables sit near -1e5 where one fp32 step is 2^-7, and that rounding
    enters the weights of every logaddexp (each side's own floor-path code
    differs from the other's by that much)."""
    rng = np.random.default_rng(1)
    B, T, C, Ul = 3, 12, 7, 6
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    tgt = rng.integers(1, C, (B, Ul))
    tgt[0, 1] = tgt[0, 0]  # a repeat: needs a blank between
    in_len = np.asarray([1.0, 0.75, 4 / 12], np.float32)
    tgt_len = np.asarray([4 / 6, 1.0, 1.0], np.float32)
    reductions = ("batch", "batchmean", "mean", "sum")

    @jax.jit
    def jax_refs(x):
        """Every reduction's loss and the batchmean gradient, one compile."""
        def f(x, reduction):
            return j_ctc_loss(jax.nn.log_softmax(x), jnp.asarray(tgt),
                              jnp.asarray(in_len), jnp.asarray(tgt_len),
                              reduction=reduction)
        losses = {r: f(x, r) for r in reductions}
        return losses, jax.grad(f)(x, "batchmean")

    refs, g_want = jax_refs(jnp.asarray(logits))
    assert 9e4 < float(refs["batch"][2]) < 1e6
    g_want = np.asarray(g_want)
    for reduction in reductions:
        x = _t(logits).requires_grad_()
        got = ctc_loss(torch.log_softmax(x, -1), _t(tgt), _t(in_len),
                       _t(tgt_len), reduction=reduction)
        if reduction == "batchmean":
            got.backward()
            np.testing.assert_allclose(x.grad.numpy()[:2], g_want[:2],
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(x.grad.numpy()[2], g_want[2],
                                       atol=1e-2, rtol=0)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(refs[reduction]),
                                   rtol=1e-6, atol=1e-4)


def test_cmvn_update_matches_jax():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 20, 5)).astype(np.float32) * 3 + 1
    rel = np.asarray([1.0, 0.62, 0.35], np.float32)
    mean = rng.standard_normal(5).astype(np.float32)
    std = (0.5 + rng.random(5)).astype(np.float32)
    want = jax.jit(j_cmvn_update)(
        JCmvn(jnp.asarray(mean), jnp.asarray(std),
              jnp.asarray(7.0, jnp.float32)),
        jnp.asarray(feats), jnp.asarray(rel))
    got = cmvn_update(CmvnState(_t(mean), _t(std), torch.tensor(7.0)),
                      _t(feats), _t(rel))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)
    assert InputNormalization(update_until_epoch=4).should_update(3)
    assert not InputNormalization(update_until_epoch=4).should_update(4)


@pytest.mark.parametrize("mode", ["bicubic", "linear"])
def test_specaugment_apply_matches_jax(mode):
    """Given the same draw, the port's apply part equals JAX's warp
    followed by its masks filled with the batch mean."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((3, 40, 12)).astype(np.float32)
    params = draw_spec_augment(feats.shape, torch.Generator().manual_seed(4),
                               n_freq_mask=2, freq_mask_width=5,
                               n_time_mask=2, time_mask_width=8)
    c, w = params.warp
    # one compile of the warp (eager, each of its operations compiles)
    warped = np.asarray(jax.jit(j_warp_to, static_argnums=3)(
        jnp.asarray(feats), jnp.int32(c), jnp.int32(w), mode))
    np.testing.assert_allclose(warp_to(_t(feats), c, w, mode).numpy(),
                               warped, atol=1e-5, rtol=0)
    want = warped.copy()
    fill = warped.mean()
    for b in range(3):
        for width, start in zip(params.freq_width[b], params.freq_start[b]):
            want[b, :, int(start):int(start + width)] = fill
        for width, start in zip(params.time_width[b], params.time_start[b]):
            want[b, int(start):int(start + width), :] = fill
    got = apply_spec_augment(_t(feats), params, time_warp_mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    none = SpecAugParams(None, *(torch.zeros((3, 0), dtype=torch.int64),) * 4)
    torch.testing.assert_close(apply_spec_augment(_t(feats), none),
                               _t(feats))


# -------------------------------------------------------------- the slice
def _make_batch(rng, B=2):
    sig = rng.standard_normal((B, WAV_LEN)).astype(np.float32) * 0.1
    sig_len = np.array([1.0] + [0.8] * (B - 1), np.float32)
    n_tok = rng.integers(4, U - 2, B)
    tokens, bos, eos = (np.zeros((B, U), np.int32) for _ in range(3))
    for b in range(B):
        seq = rng.integers(3, VOCAB, n_tok[b])
        tokens[b, : n_tok[b]] = seq
        bos[b, 0] = 1
        bos[b, 1: n_tok[b] + 1] = seq[: U - 1]
        eos[b, : n_tok[b]] = seq
        eos[b, n_tok[b]] = 2
    return {"sig": sig, "sig_len": sig_len, "tokens": tokens,
            "tokens_len": (n_tok / U).astype(np.float32), "tokens_bos": bos,
            "tokens_eos": eos,
            "tokens_eos_len": ((n_tok + 1) / U).astype(np.float32)}


def _port_batch(batch):
    return {k: (_t(v).long() if v.dtype == np.int32 else _t(v))
            for k, v in batch.items()}


def _jax_cfg():
    cnn = ConvolutionFrontEnd(out_channels=(CH, CH), dropout=0.0)
    tfm = TransformerMultiTask(
        tgt_vocab=VOCAB, input_size=(N_MELS // 4) * CH, d_model=D, nhead=H,
        num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
        dropout=0.0, normalize_before=True, max_length=512)
    return jstep.StepConfig(
        fbank=JFbank(n_mels=N_MELS), cnn=cnn, transformer=tfm,
        seq_lin=LinearHead(input_size=D, n_neurons=VOCAB),
        ctc_lin=LinearHead(input_size=D, n_neurons=VOCAB),
        specaug_opts=None, ctc_weight=0.3, label_smoothing=0.1,
        loss_reduction="batchmean", pad_index=0, blank_index=0)


def _jax_params(cfg, seed=0):
    key = jax.random.PRNGKey(0)
    f32 = jnp.float32
    shapes = {
        "CNN": jax.eval_shape(cfg.cnn.init, key,
                              jax.ShapeDtypeStruct((1, 51, N_MELS), f32)),
        "Transformer": jax.eval_shape(
            cfg.transformer.init, key,
            jax.ShapeDtypeStruct((1, 13, N_MELS // 4, CH), f32),
            jax.ShapeDtypeStruct((1, U), jnp.int32)),
        "seq_lin": jax.eval_shape(cfg.seq_lin.init, key,
                                  jax.ShapeDtypeStruct((1, 13, D), f32)),
        "ctc_lin": jax.eval_shape(cfg.ctc_lin.init, key,
                                  jax.ShapeDtypeStruct((1, 13, D), f32)),
    }
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(np.asarray(
            _seeded_leaf(path, s.shape, rng), np.float32)), shapes)


def _port_modules(jparams=None):
    mods = dict(
        cnn=P.ConvolutionFrontEnd(n_mels=N_MELS, out_channels=(CH, CH),
                                  dropout=0.0),
        transformer=P.TransformerMultiTask(
            VOCAB, (N_MELS // 4) * CH, d_model=D, nhead=H,
            num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, d_ffn=FFN,
            dropout=0.0),
        seq_lin=P.LinearHead(D, VOCAB), ctc_lin=P.LinearHead(D, VOCAB))
    if jparams is not None:
        load_jax_params(jax.tree_util.tree_map(np.asarray, jparams), **mods,
                        settings=_jax_cfg().transformer)
    return mods


def _port_cfg(mods):
    return pstep.StepConfig(
        fbank=Fbank(n_mels=N_MELS), cnn=mods["cnn"],
        transformer=mods["transformer"], seq_lin=mods["seq_lin"],
        ctc_lin=mods["ctc_lin"], specaug_opts=None, ctc_weight=0.3,
        label_smoothing=0.1, loss_reduction="batchmean", pad_index=0,
        blank_index=0)


def _cmvn(rng):
    return (rng.standard_normal(N_MELS).astype(np.float32),
            (0.5 + rng.random(N_MELS)).astype(np.float32))


def _jcmvn(mean, std):
    # fresh arrays: the JAX train step donates its state
    return JCmvn(jnp.array(mean), jnp.array(std),
                 jnp.asarray(100.0, jnp.float32))


def _port_state(cfg, tx, mean, std):
    state = pstep.init_train_state(cfg, tx, "cpu", N_MELS)
    state.cmvn = CmvnState(_t(mean), _t(std), torch.tensor(100.0))
    return state


def _as_port_named(jtree):
    """A JAX parameter-shaped tree in the port's naming, through a fresh
    port model loaded the strict way."""
    mods = _port_modules(jtree)
    key = {"cnn": "CNN", "transformer": "Transformer", "seq_lin": "seq_lin",
           "ctc_lin": "ctc_lin"}
    return {f"{key[k]}.{n}": p.detach() for k, m in mods.items()
            for n, p in m.named_parameters()}


def _assert_params(got: dict, want: dict, rtol, atol):
    """Parameters after AdamW updates. The key-projection bias shifts every
    score of a row equally, so its true gradient is exactly 0 and each
    side's is rounding noise, which Adam's first step turns into +-lr:
    those entries agree to 2 lr only (the kernel and plain paths round
    differently)."""
    assert set(got) == set(want)
    got = dict(got)
    for name in got:
        if name.endswith("in_proj.bias"):
            k = slice(D, 2 * D)
            assert float((got[name][k] - want[name][k]).abs().max()) \
                <= 2 * LR * 1.001
            got[name] = got[name].clone()
            got[name][k] = want[name][k]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def _slice_batches():
    rng = np.random.default_rng(2024)
    mean, std = _cmvn(rng)
    batches = [_make_batch(rng) for _ in range(5)]
    batches[3]["sig"][0, 100] = np.nan
    return batches, mean, std


def _jax_slice_reference():
    """The JAX half of ``slice_run`` as host arrays: five microsteps of
    the JAX step with its Pallas training kernels in interpret mode, and
    the microbatch-1 gradients."""
    batches, mean, std = _slice_batches()
    cfg_j = _jax_cfg()
    params_j = _jax_params(cfg_j)
    sched = JSched(lr=LR, **SCHED)
    tx_j = jstep.make_optimizer(JAdamW(lr=LR), sched.value, ACCUM, CLIP, 10)

    def jbatch(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    # one program for the copy (the step donates its state) and the
    # optimizer's init, not one small compile a leaf
    params0, opt0 = jax.jit(lambda p: (
        jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), p),
        tx_j.init(p)))(params_j)
    state_j = jstep.TrainState(
        params=params0, opt_state=opt0, cmvn=_jcmvn(mean, std),
        optimizer_step=jnp.zeros((), jnp.int32),
        micro_step=jnp.zeros((), jnp.int32))
    losses_j, norms_j = [], []
    # the Pallas training kernels in interpret mode (the JAX trainer's
    # accelerator default); disabled in `finally`, so the global flag
    # never reaches another test of this worker
    jpallas.enable_train(interpret=True)
    try:
        step_j = jstep.make_train_step(cfg_j, tx_j)
        for i, b in enumerate(batches):
            state_j, m = step_j(state_j, jbatch(b), jax.random.PRNGKey(0))
            losses_j.append(float(m["loss"]))
            norms_j.append(float(m["grad_norm"]))
            if i == 0:  # MultiSteps' running mean of one microbatch
                grad_j = jax.tree_util.tree_map(np.asarray,
                                                state_j.opt_state.acc_grads)
    finally:
        jpallas.disable()
    host = partial(jax.tree_util.tree_map, np.asarray)
    return dict(params_j=host(params_j), grad_j=grad_j,
                state_j=SimpleNamespace(
                    params=host(state_j.params),
                    optimizer_step=int(state_j.optimizer_step),
                    micro_step=int(state_j.micro_step)),
                losses_j=losses_j, norms_j=norms_j)


@pytest.fixture(scope="module")
def slice_inputs():
    """The slice's batches, CMVN and initial JAX parameters (host arrays,
    the ones ``_jax_slice_reference`` starts from), and one jitted JAX
    eval forward for every test of the module: what the tests that run
    neither step need, without waiting for the steps."""
    batches, mean, std = _slice_batches()
    cfg_j = _jax_cfg()
    return dict(batches=batches, mean=mean, std=std, cfg_j=cfg_j,
                params_j=jax.tree_util.tree_map(np.asarray,
                                                _jax_params(cfg_j)),
                eval_j=jstep.make_eval_forward(cfg_j))


def _port_slice_run(params_j, batches, mean, std):
    """The port half of ``slice_run``: the same five microsteps and
    microbatch-1 gradients on the port's step, as host tensors by the
    port's parameter names."""
    cfg_p = _port_cfg(_port_modules(params_j))
    tx_p = pstep.make_optimizer(
        AdamW(lr=LR), WarmCoolDecayLRSchedule(lr=LR, **SCHED).value, ACCUM,
        CLIP, 10)
    state_p = _port_state(cfg_p, tx_p, mean, std)
    _, grad_p, _ = pstep.loss_and_grad(cfg_p, state_p, _port_batch(batches[0]),
                                       0)
    grads_p = {n: t.detach().clone()
               for n, t in state_p.params.named(grad_p).items()}
    step_p = pstep.make_train_step(cfg_p, tx_p)
    losses_p, norms_p = [], []
    for b in batches:
        state_p, m = step_p(state_p, _port_batch(b), 0)
        losses_p.append(float(m["loss"]))
        norms_p.append(float(m["grad_norm"]))
    return dict(grads_p=grads_p, losses_p=losses_p, norms_p=norms_p,
                params_p={n: t.detach().clone()
                          for n, t in state_p.params.named().items()},
                optimizer_step_p=state_p.optimizer_step,
                micro_step_p=state_p.micro_step)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory, slice_inputs):
    """Five microsteps of both steps (accumulation 2; batch 4 is NaN, a
    group boundary), and the microbatch-1 gradients of both; each half
    built once a run."""
    r = slice_inputs
    halves = built_once_all(tmp_path_factory, {
        "torch_slice_run": _jax_slice_reference,
        "torch_slice_run_port": lambda: _port_slice_run(
            r["params_j"], r["batches"], r["mean"], r["std"])})
    return dict(r, **halves["torch_slice_run"],
                **halves["torch_slice_run_port"])


def test_slice_losses_match_jax(slice_run):
    r = slice_run
    assert np.isnan(r["losses_j"][3]) and np.isnan(r["losses_p"][3])
    np.testing.assert_allclose(r["losses_p"], r["losses_j"], rtol=2e-5)
    np.testing.assert_allclose(r["norms_p"][:3], r["norms_j"][:3], rtol=1e-4)
    assert max(r["norms_j"][:3]) > CLIP  # the clip is exercised


def test_slice_gradients_match_jax(slice_run):
    r = slice_run
    want = _as_port_named(r["grad_j"])
    got = r["grads_p"]
    scale = max(float(w.abs().max()) for w in want.values())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-3,
                                   atol=2e-5 * scale, err_msg=name)


def test_slice_parameters_match_jax_after_five_microsteps(slice_run):
    r = slice_run
    assert r["optimizer_step_p"] == int(r["state_j"].optimizer_step) == 2
    assert r["micro_step_p"] == int(r["state_j"].micro_step) == 5
    want = _as_port_named(jax.tree_util.tree_map(np.asarray,
                                                 r["state_j"].params))
    got = r["params_p"]
    _assert_params(got, want, rtol=5e-3, atol=5e-4)
    # the NaN group was skipped: the update of group 1 is the only one
    moved = [float((got[n] - w).abs().max()) for n, w in
             _as_port_named(r["params_j"]).items()]
    assert max(moved) > 1e-3


def test_eval_forward_matches_jax(slice_inputs):
    """The port's eval forward (flash_attention's plain version on the
    key-padding routes) against JAX's eval forward, fp32 atol 1e-4."""
    r = slice_inputs
    batch = r["batches"][1]
    p_ctc_j, p_seq_j, enc_j = r["eval_j"](
        r["params_j"], _jcmvn(r["mean"], r["std"]), {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    cfg_p = _port_cfg(_port_modules(r["params_j"]))
    tx_p = pstep.make_optimizer(AdamW(lr=LR), lambda s: LR)
    state = _port_state(cfg_p, tx_p, r["mean"], r["std"])
    p_ctc, p_seq, enc = pstep.make_eval_forward(cfg_p)(
        state.params, state.cmvn, _port_batch(batch))
    for got, want in ((p_ctc, p_ctc_j), (p_seq, p_seq_j), (enc, enc_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)


# ---------------------------------------------------------------- trainer
def _padded_batches(rng, n):
    out = []
    for i in range(n):
        b = _make_batch(rng)
        samples = []
        for r in range(2):
            k = int(round(b["tokens_len"][r] * U))
            samples.append(dict(
                id=f"u{i}{r}", sig=b["sig"][r][: int(b["sig_len"][r]
                                                     * WAV_LEN)],
                duration=0.5, task="translation", source_lang="es",
                target_lang="en", tokens=b["tokens"][r][:k],
                tokens_bos=b["tokens_bos"][r][: k + 1],
                tokens_eos=b["tokens_eos"][r][: k + 1]))
        out.append(collate_batch(samples, audio_pad_samples=WAV_LEN,
                                 token_pad_multiple=U))
    return out


def _trainer(jparams, **run_opts):
    mods = _port_modules(jparams)
    modules = {"CNN": mods["cnn"], "Transformer": mods["transformer"],
               "seq_lin": mods["seq_lin"], "ctc_lin": mods["ctc_lin"],
               "normalize": InputNormalization(update_until_epoch=4)}
    hparams = dict(compute_features=Fbank(n_mels=N_MELS), ctc_weight=0.3,
                   label_smoothing=0.1, loss_reduction="batchmean",
                   n_mels=N_MELS, seed=11, grad_accumulation_factor=1,
                   lr_scheduler=WarmCoolDecayLRSchedule(lr=LR, **SCHED))
    return STTrainer(modules, AdamW(lr=LR), hparams, run_opts, device="cpu")


def test_trainer_fit_equals_direct_steps(slice_inputs):
    batches = _padded_batches(np.random.default_rng(7), 3)
    trainer = _trainer(slice_inputs["params_j"])
    trainer.fit([1], batches)
    assert trainer.state.optimizer_step == trainer.state.micro_step == 3
    assert float(trainer.state.cmvn.count) == 6.0  # epoch 1 < 4 updates

    other = _trainer(slice_inputs["params_j"])
    state = other.ensure_state()
    gen = torch.Generator().manual_seed(11)
    for b in batches:
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
        state, _ = other.train_step(state, other._device_batch(b), seed,
                                    update_cmvn=True)
    got, want = trainer.state.params.named(), state.params.named()
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=0, rtol=0)
    assert np.isfinite(trainer.train_stats["loss"])


def test_pcm16_device_batch_is_exact():
    pcm = np.random.default_rng(8).integers(-3000, 3000, (2, WAV_LEN))
    batch = _padded_batches(np.random.default_rng(9), 1)[0]
    batch.sig[0][:] = (pcm / 32768.0).astype(np.float32)
    trainer = _trainer(None, transfer_int16=True)
    dev = trainer._device_batch(batch)
    assert dev["sig"].dtype == torch.int16
    np.testing.assert_array_equal(dev["sig"].numpy(), pcm)
    fb = Fbank(n_mels=N_MELS)
    torch.testing.assert_close(fb(dev["sig"].float() / 32768.0),
                               fb(_t(batch.sig.data)), atol=0, rtol=0)
    assert dev["tokens"].dtype == torch.int64


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        STTrainer({"CNN": None, "Transformer": None, "seq_lin": None},
                  AdamW(), {"compute_features": None})


def test_collate_and_pad_rows_match_jax():
    from stac_st_tpu.data import dataset as jdata
    from stac_st_tpu_torch.data.dataset import pad_batch_rows

    rng = np.random.default_rng(10)
    samples = [dict(id=f"u{i}", sig=rng.standard_normal(n).astype(np.float32),
                    duration=n / 16000, task="translation", source_lang="es",
                    target_lang="en", tokens=rng.integers(3, 50, k),
                    tokens_bos=rng.integers(3, 50, k + 1),
                    tokens_eos=rng.integers(3, 50, k + 1), extra=i)
               for i, (n, k) in enumerate([(9000, 5), (12000, 9), (3000, 2)])]
    for kw in ({}, {"audio_pad_samples": 8000, "batch_size_pad": 4}):
        got = collate_batch(samples, **kw)
        want = jdata.collate_batch(samples, **kw)
        for name in ("sig", "tokens", "tokens_bos", "tokens_eos"):
            for g, w in zip(getattr(got, name), getattr(want, name)):
                np.testing.assert_array_equal(g, w)
        assert got.extras == want.extras and got.id == want.id
        arrays = {"sig": got.sig.data, "sig_len": got.sig.lengths}
        for g, w in zip(pad_batch_rows(arrays, 4).values(),
                        jdata.pad_batch_rows(arrays, 4).values()):
            np.testing.assert_array_equal(g, w)


def test_validation_loss_and_acc_match_jax(slice_inputs, monkeypatch):
    """The port's validation (teacher-forced loss and ACC, no search)
    against the JAX trainer's ``_validate`` on identical batches, weights
    and CMVN: fp32, atol 1e-4. The JAX trainer runs the module's one
    compiled eval forward, and its losses compiled once (eager, each
    operation compiles on its own)."""
    from stac_st_tpu.training.trainer import STTrainer as JaxTrainer
    from stac_st_tpu.utils.metrics import AccuracyStats as JaxAccuracy
    from stac_st_tpu_torch.utils.metrics import AccuracyStats

    r = slice_inputs
    batches = _padded_batches(np.random.default_rng(12), 2)
    cfg = r["cfg_j"]
    # eos wins the argmax, so ACC counts each row's eos position
    params = jax.tree_util.tree_map(np.asarray, r["params_j"])
    params["seq_lin"]["params"]["linear"]["bias"] = (
        params["seq_lin"]["params"]["linear"]["bias"]
        + 20.0 * (np.arange(VOCAB) == 2)).astype(np.float32)
    jax_trainer = JaxTrainer(
        {"CNN": cfg.cnn, "Transformer": cfg.transformer,
         "seq_lin": cfg.seq_lin, "ctc_lin": cfg.ctc_lin},
        hparams=dict(compute_features=cfg.fbank, ctc_weight=0.3,
                     label_smoothing=0.1, loss_reduction="batchmean",
                     n_mels=N_MELS, acc_computer=JaxAccuracy),
        run_opts={"data_parallel_count": 1})
    # the module's compiled eval forward, on the batch as uncommitted
    # arrays (the trainer's are committed to its one-device mesh, which
    # would compile the same program again)
    jax_trainer.eval_forward = lambda p, c, b: r["eval_j"](
        p, c, {k: jnp.asarray(np.asarray(v)) for k, v in b.items()})
    original = jstep._objectives
    objectives = jax.jit(lambda p_ctc, p_seq, batch: original(
        p_ctc, p_seq, batch, cfg))
    monkeypatch.setattr(jstep, "_objectives",
                        lambda p_ctc, p_seq, batch, _: objectives(
                            p_ctc, p_seq, batch))
    jax_trainer.state = jstep.TrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=None,
        cmvn=_jcmvn(r["mean"], r["std"]),
        optimizer_step=jnp.zeros((), jnp.int32),
        micro_step=jnp.zeros((), jnp.int32))
    want = jax_trainer._validate(batches, 1)

    trainer = _trainer(params)
    trainer.hparams["acc_computer"] = AccuracyStats
    trainer.ensure_state().cmvn = CmvnState(_t(r["mean"]), _t(r["std"]),
                                            torch.tensor(100.0))
    got = trainer._validate(batches, 1)
    assert set(got) == set(want) == {"loss", "ACC"}
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["ACC"], want["ACC"], atol=1e-4, rtol=0)
    assert 0.0 < want["ACC"] < 1.0
