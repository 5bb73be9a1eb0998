"""The trainer's run options and its optimizer state across packages.

* ``train_attn_kernel=off``: the port's train step (fp32, dropout 0,
  accumulation 2, clipping at 1.0, patience 10) against the JAX step on
  its XLA attention (no Pallas kernel), at ``tests/test_train_oracle.py``'s
  tolerances: per-step loss rtol 2e-5, parameters rtol 5e-3 with atol
  5e-4 (per-step noise through AdamW; the key-projection bias, whose true
  gradient is 0, to 2 lr). ``auto`` and ``on`` route key-padding
  attention to the kernels' wrappers, ``off`` to neither (calls counted).
* ``rng_impl``: the JAX trainer's values accepted, logged once; another
  raises.
* Adam's moments across packages with a jitted JAX step: the JAX run
  checkpointed after three microsteps (mid-group: the accumulator and
  ``mini_step`` set) resumes in the port, and the port's checkpoint in
  the JAX trainer's ``load_from_checkpoint``; the fourth microstep of
  each equals the other package's uninterrupted one at the tolerances
  above. The optax layout the port writes equals
  ``flax.serialization.to_state_dict`` of a real JAX state.

One test reads the JAX run, so each test run builds it once, in one
worker.
"""

import logging
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)
from flax import serialization

from stac_st_tpu.training import step as jstep
from stac_st_tpu.training.checkpoint import Checkpointer as JCheckpointer
from stac_st_tpu.training.optim import AdamW as JAdamW
from stac_st_tpu.training.schedulers import WarmCoolDecayLRSchedule as JSched
from stac_st_tpu.training.trainer import STTrainer as JaxTrainer

from stac_st_tpu_torch.interop.from_jax import optax_opt_tree
from stac_st_tpu_torch.models import transformer as ptransformer
from stac_st_tpu_torch.ops.cmvn import CmvnState, InputNormalization
from stac_st_tpu_torch.ops.fbank import Fbank
from stac_st_tpu_torch.training import trainer as ptrainer
from stac_st_tpu_torch.training.checkpoint import Checkpointer
from stac_st_tpu_torch.training.optim import AdamW
from stac_st_tpu_torch.training.schedulers import WarmCoolDecayLRSchedule
from stac_st_tpu_torch.training.trainer import STTrainer

from test_torch_train_step import (
    ACCUM,
    CLIP,
    LR,
    N_MELS,
    SCHED,
    _as_port_named,
    _assert_params,
    _cmvn,
    _jax_cfg,
    _jax_params,
    _jcmvn,
    _make_batch,
    _port_batch,
    _port_modules,
    _t,
)

PATIENCE = 10
CKPT_AFTER = 3  # microsteps before the checkpoint: mid accumulation group


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _tx():
    return jstep.make_optimizer(JAdamW(lr=LR), JSched(lr=LR, **SCHED).value,
                                ACCUM, CLIP, PATIENCE)


def _fresh_state(params, mean, std):
    return jstep.TrainState(
        params=jax.tree_util.tree_map(jnp.array, params),
        opt_state=_tx().init(params), cmvn=_jcmvn(mean, std),
        optimizer_step=jnp.zeros((), jnp.int32),
        micro_step=jnp.zeros((), jnp.int32))


def _jax_reference():
    """Four microsteps of the JAX step (XLA attention) and the state after
    the third and after the fourth, on the host; and, with the same
    compiled step, the JAX trainer's fourth microstep from the port's
    checkpoint written after three."""
    rng = np.random.default_rng(77)
    mean, std = _cmvn(rng)
    batches = [_make_batch(rng) for _ in range(4)]
    params = _host(_jax_params(_jax_cfg()))
    step = jstep.make_train_step(_jax_cfg(), _tx())
    state, losses, mid = _fresh_state(params, mean, std), [], None
    for i, b in enumerate(batches):
        state, m = step(state, _jbatch(b), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        if i + 1 == CKPT_AFTER:
            mid = _host(state)
    ref = dict(params=params, batches=batches, mean=mean, std=std,
               losses=losses, mid=mid, final=_host(state))
    with tempfile.TemporaryDirectory() as d:
        trainer = _port_trainer(params, mean, std,
                                checkpointer=Checkpointer(d),
                                train_attn_kernel="off")
        _steps(trainer, batches[:CKPT_AFTER])
        trainer.checkpointer.save_checkpoint(
            meta={"epoch": 1}, trees=trainer._checkpoint_trees(1))
        jt = _jax_trainer(ref)
        jt.load_from_checkpoint(JCheckpointer(d).recover_if_possible())
    ref["from_port_mini_step"] = int(jt.state.opt_state.mini_step)
    state = jax.tree_util.tree_map(jnp.asarray, jt.state)
    for b in batches[CKPT_AFTER:]:
        state, _ = step(state, _jbatch(b), jax.random.PRNGKey(0))
    ref["from_port"] = _host(state)
    return ref


@pytest.fixture(scope="module")
def jax_run():
    return _jax_reference()


def _port_trainer(jparams, mean, std, checkpointer=None, **run_opts):
    mods = _port_modules(jparams)
    modules = {"CNN": mods["cnn"], "Transformer": mods["transformer"],
               "seq_lin": mods["seq_lin"], "ctc_lin": mods["ctc_lin"],
               "normalize": InputNormalization(update_until_epoch=4)}
    hparams = dict(compute_features=Fbank(n_mels=N_MELS), ctc_weight=0.3,
                   label_smoothing=0.1, loss_reduction="batchmean",
                   n_mels=N_MELS, seed=11, grad_accumulation_factor=ACCUM,
                   use_grad_clipping=True, max_grad_norm=CLIP,
                   nonfinite_patience=PATIENCE,
                   lr_scheduler=WarmCoolDecayLRSchedule(lr=LR, **SCHED))
    trainer = STTrainer(modules, AdamW(lr=LR), hparams,
                        dict(run_opts, device="cpu"),
                        checkpointer=checkpointer)
    state = trainer.ensure_state()
    if checkpointer is None or checkpointer.recover_if_possible() is None:
        state.cmvn = CmvnState(_t(mean), _t(std), torch.tensor(100.0))
    return trainer


def _steps(trainer, batches):
    losses = []
    for b in batches:
        trainer.state, m = trainer.train_step(trainer.state, _port_batch(b), 0)
        losses.append(float(m["loss"]))
    return losses


def _jax_trainer(r):
    cfg = _jax_cfg()
    trainer = JaxTrainer(
        {"CNN": cfg.cnn, "Transformer": cfg.transformer,
         "seq_lin": cfg.seq_lin, "ctc_lin": cfg.ctc_lin},
        opt_class=JAdamW(lr=LR),
        hparams=dict(compute_features=cfg.fbank, ctc_weight=0.3,
                     label_smoothing=0.1, loss_reduction="batchmean",
                     n_mels=N_MELS, grad_accumulation_factor=ACCUM,
                     use_grad_clipping=True, max_grad_norm=CLIP,
                     nonfinite_patience=PATIENCE,
                     lr_scheduler=JSched(lr=LR, **SCHED)),
        # threefry: the default (rbg) would switch the process-global PRNG
        # and with it the shape of the shared step's key
        run_opts={"data_parallel_count": 1, "rng_impl": "threefry"})
    trainer.state = _fresh_state(r["params"], r["mean"], r["std"])
    return trainer


def _assert_state(trainer, jstate):
    want = _as_port_named(jstate.params)
    got = {n: t.detach() for n, t in trainer.state.params.named().items()}
    _assert_params(got, want, rtol=5e-3, atol=5e-4)
    assert trainer.state.optimizer_step == int(jstate.optimizer_step)
    assert trainer.state.micro_step == int(jstate.micro_step)


# ----------------------------------------------------- train_attn_kernel
@pytest.mark.parametrize("value,kernel", [("auto", True), ("on", True),
                                          ("off", False)])
def test_attn_kernel_routes(monkeypatch, value, kernel):
    """Calls of the flash wrappers in one train step and one eval
    forward: 2 encoder self-attention + 2 cross-attention layers each."""
    calls = {"flash_attention_train": 0, "flash_attention": 0}

    def counted(name):
        original = getattr(ptransformer, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return original(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(ptransformer, name, counted(name))
    rng = np.random.default_rng(5)
    trainer = _port_trainer(None, *_cmvn(rng), train_attn_kernel=value)
    _steps(trainer, [_make_batch(rng)])
    trainer.eval_forward(trainer.state.params, trainer.state.cmvn,
                         _port_batch(_make_batch(rng)))
    n = 4 if kernel else 0
    assert calls == {"flash_attention_train": n, "flash_attention": n}


# --------------------------------------------------------------- rng_impl
def test_run_option_values(monkeypatch, caplog):
    """rng_impl: the JAX trainer's values accepted (lower-cased), logged
    once, another raises; an unknown train_attn_kernel raises."""
    with pytest.raises(ValueError, match="train_attn_kernel"):
        _port_trainer(None, *_cmvn(np.random.default_rng(6)),
                      train_attn_kernel="sometimes")
    monkeypatch.setattr(ptrainer, "_rng_logged", False)
    accepted = [f"{base}{suffix}" for base in ("rbg", "unsafe_rbg",
                                               "threefry")
                for suffix in ("", "_scoped")] + ["RBG"]
    with caplog.at_level(logging.INFO, logger=ptrainer.__name__):
        for value in accepted:
            assert ptrainer.check_rng_impl(value) == value.lower()
    logged = [rec for rec in caplog.records if "rng_impl" in rec.message]
    assert len(logged) == 1
    for value in ("philox", "rbg_global", "scoped"):
        with pytest.raises(ValueError, match="rng_impl"):
            ptrainer.check_rng_impl(value)


# ------------------------------------------------ Adam's moments, both ways
@pytest.mark.parametrize("accum,clip,patience,kind", [
    (ACCUM, CLIP, PATIENCE, "adamw"), (1, None, 100, "adamw"),
    (1, CLIP, 0, "adam")])
def test_optax_layout_equals_a_real_state(accum, clip, patience, kind):
    """Keys, shapes and dtypes of the port's ``opt`` tree against
    ``to_state_dict`` of the JAX chain's own initial state."""
    from stac_st_tpu.training.optim import Adam as JAdam

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        a = np.asarray(tree)
        return (a.shape, a.dtype.name)

    params = {"CNN": {"params": {"w": {"kernel": jnp.ones((2, 3))}}},
              "seq_lin": {"params": {"b": jnp.zeros(4)}}}
    zeros = _host(params)
    factory = JAdamW(lr=LR) if kind == "adamw" else JAdam(lr=LR)
    tx = jstep.make_optimizer(factory, lambda c: LR, accum, clip, patience)
    want = serialization.to_state_dict(tx.init(params))
    got = optax_opt_tree(zeros, zeros, count=0, sched_count=0, kind=kind,
                         clip=bool(clip), patience=patience, accum=accum,
                         acc=zeros if accum > 1 else None)
    assert layout(got) == layout(_host(want))
    restored = serialization.from_state_dict(tx.init(params), got)
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(tx.init(params))


def test_off_step_and_moments_across_packages_match_jax(jax_run, tmp_path):
    """train_attn_kernel=off: four microsteps against the JAX XLA step.
    JAX -> port: the JAX run's checkpoint after three microsteps resumes
    in the port, whose fourth microstep equals the JAX run's. Port -> JAX:
    the port's checkpoint after three, read by the JAX trainer's
    ``load_from_checkpoint`` (in the reference build): its fourth
    microstep equals the port's."""
    r = jax_run
    trainer = _port_trainer(r["params"], r["mean"], r["std"],
                            train_attn_kernel="off")
    losses = _steps(trainer, r["batches"][:CKPT_AFTER])
    trees = trainer._checkpoint_trees(1)
    assert set(trees) >= {"opt", "opt_torch"}
    losses += _steps(trainer, r["batches"][CKPT_AFTER:])
    np.testing.assert_allclose(losses, r["losses"], rtol=2e-5)
    _assert_state(trainer, r["final"])
    assert trainer.state.optimizer_step == 2
    assert r["from_port_mini_step"] == 1
    _assert_state(trainer, r["from_port"])

    jt = _jax_trainer(r)
    jt.state = r["mid"]
    JCheckpointer(str(tmp_path)).save_checkpoint(
        meta={"epoch": 1}, trees=jt._checkpoint_trees(1))
    resumed = _port_trainer(r["params"], r["mean"], r["std"],
                            checkpointer=Checkpointer(str(tmp_path)),
                            train_attn_kernel="off")
    st = resumed.state.opt_state
    assert (st.mini_step, st.sched_count, float(st.count)) == (1, 1, 1.0)
    assert float(st.mu.abs().max()) > 0 and float(st.acc.abs().max()) > 0
    losses = _steps(resumed, r["batches"][CKPT_AFTER:])
    np.testing.assert_allclose(losses, r["losses"][CKPT_AFTER:], rtol=2e-5)
    _assert_state(resumed, r["final"])
