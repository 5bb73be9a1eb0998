"""The port's continuous batching against the JAX package's, on the tiny
fixture (d32, 4 heads, 2 + 2 layers, vocab 150), fp32 on the CPU.

* ``decode_step_rows`` (R slots at ragged cache indices, one past the
  cache, a per-slot cross bias) and ``decode_window`` (a primed window, at
  position 0 and mid-cache) against the JAX methods through
  ``model.apply``: hidden states and caches at atol 1e-4; the plain ragged
  self-attention against the JAX XLA formulation (``where(pos > idx)``
  bias, softmax, · V).
* ``ContinuousBatchingEngine``: tokens exactly equal to one JAX
  ``ContinuousBatchingEngine`` on the same weights (Pallas off), with mixed
  ASR and ST prompts, staggered arrivals, slot reuse, early eos and the
  budget cut. Every utterance fills its bucket, so no batch shares padding
  with another and the fbank's batch-wide ``top_db`` floor binds only on
  silent rows: a row's encoder output does not depend on its group.
* ``protocol_finalize``: finals equal to the port's ``STEngine.translate``;
  ``close()`` right after submitting fails none; the finalizer's shutdown
  race (the slot loop queues its last draft and exits after the
  finalizer's wait timed out) finalizes the draft.
"""

import os
import queue
import sys
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_model import (  # noqa: E402
    D, LAYERS, NHEAD, build_jax_tiny, build_port_twin)

from stac_st_tpu_torch.ops.kernels import decode_attention as K  # noqa: E402
from stac_st_tpu_torch.serving_continuous import (  # noqa: E402
    ContinuousBatchingEngine,
)

ATOL = 1e-4
CAP = 10
WIDTH = 8000  # the one bucket, 0.5 s


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    import jax.numpy as jnp

    jx = build_jax_tiny(seed=3)
    # eos competitive: some utterances end early, others hit the budget
    seq = jx["params"]["seq_lin"]["params"]["linear"]
    seq["bias"] = seq["bias"].at[2].add(2.9)
    return jx, build_port_twin(jx), jnp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------- ragged decode
def _caches(tiny, rng, R, S_enc, cap, lens):
    """The same decode cache on both sides: random encoder output, the
    per-slot bias of ``lens`` valid frames, random self K/V."""
    jx, pt, jnp = tiny
    t = jx["transformer"]
    enc = rng.standard_normal((R, S_enc, D)).astype(np.float32)
    bias = np.where(np.arange(S_enc)[None, :] < np.asarray(lens)[:, None],
                    0.0, -1e9).astype(np.float32)
    cj = jax.jit(lambda e, b: t.apply(
        jx["params"]["Transformer"], e, cap, b, 1, False, None,
        method=t.init_decode_cache))(jnp.asarray(enc),
                                     jnp.asarray(bias[:, None, None, :]))
    cp = pt["transformer"].init_decode_cache(_t(enc), cap, _t(bias))
    for lj, lp in zip(cj["layers"], cp["layers"]):
        k = rng.standard_normal(lp["self"]["k"].shape).astype(np.float32)
        v = rng.standard_normal(lp["self"]["v"].shape).astype(np.float32)
        lj["self"] = {**lj["self"], "k": jnp.asarray(k), "v": jnp.asarray(v)}
        lp["self"]["k"].copy_(_t(k))
        lp["self"]["v"].copy_(_t(v))
    return cj, cp


def _assert_caches(cj, cp):
    for lj, lp in zip(cj["layers"], cp["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(lp["self"][name].numpy(),
                                       np.asarray(lj["self"][name]),
                                       atol=ATOL, rtol=0)
        np.testing.assert_array_equal(
            np.asarray(lp["self"]["index"]).reshape(-1),
            np.asarray(lj["self"]["index"]).reshape(-1))


def test_decode_step_rows_matches_jax(tiny):
    """Four slots at indices 2, 5, 7 and 10 of an 8-position cache (the
    last past it: it appends nothing and reads all 8), two steps."""
    jx, pt, jnp = tiny
    t = jx["transformer"]
    rng = np.random.default_rng(11)
    R, cap = 4, 8
    cj, cp = _caches(tiny, rng, R, 11, cap, [11, 7, 3, 9])
    idx = np.asarray([2, 5, 7, 10], np.int32)
    for lj, lp in zip(cj["layers"], cp["layers"]):
        lj["self"]["index"] = jnp.asarray(idx.reshape(R, 1, 1, 1))
        lp["self"]["index"] = _t(idx)
    model = pt["transformer"].eval()
    step_j = jax.jit(lambda tok, pos, c: t.apply(
        jx["params"]["Transformer"], tok, pos, c, method=t.decode_step_rows))
    for step in range(2):
        tokens = rng.integers(3, 150, R).astype(np.int32)
        pos = idx + step
        hj, cj = step_j(jnp.asarray(tokens), jnp.asarray(pos), cj)
        with torch.no_grad():
            hp = model.decode_step_rows(_t(tokens).long(), _t(pos), cp)
        np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL,
                                   rtol=0)
        _assert_caches(cj, cp)


@pytest.mark.parametrize("start", [0, 4])
def test_decode_window_matches_jax(tiny, start):
    """A three-token window at cache position ``start`` (0: the prompt
    priming of admission; 4: over a cached prefix), per-slot bias."""
    jx, pt, jnp = tiny
    t = jx["transformer"]
    rng = np.random.default_rng(12 + start)
    cj, cp = _caches(tiny, rng, 2, 11, 13, [11, 5])
    for lj, lp in zip(cj["layers"], cp["layers"]):
        lj["self"]["index"] = jnp.asarray(start, jnp.int32)
        lp["self"]["index"] = start
    tokens = rng.integers(3, 150, (2, 3)).astype(np.int32)
    hj, cj = jax.jit(lambda tok, pos, c: t.apply(
        jx["params"]["Transformer"], tok, pos, c, method=t.decode_window))(
            jnp.asarray(tokens), jnp.asarray(start, jnp.int32), cj)
    with torch.no_grad():
        hp = pt["transformer"].decode_window(_t(tokens).long(), start, cp)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL, rtol=0)
    _assert_caches(cj, cp)


def test_ragged_self_attention_ref_matches_jax_formulation(tiny):
    """The plain ragged self-attention (pre-scaled q) against the JAX
    package's XLA path for a per-row index: bias -1e9 where pos > idx,
    softmax of q·Kᵀ·scale + bias, · V; indices 0, mid, S - 1 and past S."""
    _, _, jnp = tiny
    import jax

    rng = np.random.default_rng(13)
    BB, H, Dh, S = 5, 2, 64, 40
    q = rng.standard_normal((BB, H, Dh)).astype(np.float32)
    kT = rng.standard_normal((BB, H, Dh, S)).astype(np.float32)
    v = rng.standard_normal((BB, H, S, Dh)).astype(np.float32)
    idx = np.asarray([0, 17, 39, 40, 75], np.int32)
    scale = 1.0 / np.sqrt(Dh)
    pos_bias = jnp.where(jnp.arange(S)[None, None, None, :]
                         > jnp.asarray(idx).reshape(BB, 1, 1, 1), -1e9, 0.0)
    logits = jnp.matmul(jnp.asarray(q)[:, :, None, :],
                        jnp.asarray(kT)) * scale + pos_bias
    want = jnp.matmul(jax.nn.softmax(logits, axis=-1),
                      jnp.asarray(v))[:, :, 0]
    got = K.decode_self_attention_ref(_t(q * np.float32(scale)), _t(kT),
                                      _t(v), _t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # the wrapper takes the plain version for CPU tensors, both forms
    assert torch.equal(K.decode_self_attention(_t(q), _t(kT), _t(v),
                                               _t(idx)),
                       K.decode_self_attention_ref(_t(q), _t(kT), _t(v),
                                                   _t(idx)))


# ---------------------------------------------------- the engines, whole
@pytest.fixture(scope="module")
def served(tiny, tmp_path_factory):
    """A JAX and a port STEngine on the same weights (one 0.5 s bucket,
    fp32, at most CAP tokens) and seeded full-bucket requests."""
    from fixtures import make_corpus, train_fixture_tokenizer
    from stac_st_tpu.ops.cmvn import cmvn_init as jax_cmvn_init
    from stac_st_tpu.serving import STEngine as JaxEngine
    from stac_st_tpu_torch.ops.cmvn import cmvn_init
    from stac_st_tpu_torch.serving import STEngine

    jx, _, _ = tiny
    root = str(tmp_path_factory.mktemp("torch_continuous"))
    _, _, joint = make_corpus(root, n_utts=4, seconds=0.4)
    sp, _ = train_fixture_tokenizer(root, joint, vocab=150)
    opts = dict(beam_size=2, bucket_seconds=(0.5,), bf16=False,
                max_decode_tokens=CAP)
    jax_engine = JaxEngine(jx["transformer"], jx["cnn"], jx["seq_lin"], None,
                           jx["params"], jax_cmvn_init(80), sp, **opts)
    pt = build_port_twin(jx)
    port = STEngine(pt["transformer"], pt["cnn"], pt["seq_lin"], None,
                    cmvn_init(80), sp, device="cpu", **opts)
    rng = np.random.default_rng(21)
    reqs = [((0.3 + 0.1 * (i % 5)) * rng.standard_normal(WIDTH))
            .astype(np.float32) for i in range(9)]
    tasks = ["translate", "transcribe", "translate", "translate",
             "transcribe", "translate", "transcribe", "translate",
             "translate"]
    return jax_engine, port, reqs, tasks


def _serve(cont, reqs, tasks):
    """Submit in three staggered waves (the later ones arrive while slots
    are busy mid-decode); returns the texts in submission order."""
    futs = []
    for lo, hi in ((0, 4), (4, 7), (7, 9)):
        futs += [cont.submit(w, task) for w, task in
                 zip(reqs[lo:hi], tasks[lo:hi])]
        time.sleep(0.02)
    return [f.result(timeout=120) for f in futs]


def test_continuous_tokens_equal_jax_continuous(served):
    from stac_st_tpu.serving_continuous import (
        ContinuousBatchingEngine as JaxContinuous,
    )

    jax_engine, port, reqs, tasks = served
    opts = dict(slots=3, chunk=4, admit_rungs=(1, 3))
    jc = JaxContinuous(jax_engine, **opts)
    pc = ContinuousBatchingEngine(port, **opts)
    lengths, finish = [], pc._finish

    def record(s):
        lengths.append(len(pc._slots[s].tokens))
        finish(s)

    pc._finish = record
    try:
        want = _serve(jc, reqs, tasks)
        got = _serve(pc, reqs, tasks)
        stats = pc.stats()
    finally:
        jc.close()
        pc.close()
    assert got == want
    # early eos beside the budget cut (min(valid frames, CAP) = CAP here)
    assert max(lengths) == CAP and min(lengths) < CAP
    assert stats["completed"] == stats["submitted"] == len(reqs)
    assert stats["admits"] == len(reqs) and stats["admit_calls"] > 1
    assert stats["tokens"] == sum(lengths)
    assert 0.0 < pc.utilization() <= 1.0


def test_protocol_finalize_gives_the_engines_beam_text(served):
    _, port, reqs, tasks = served
    drafts = []
    pc = ContinuousBatchingEngine(port, slots=3, chunk=4, admit_rungs=(1, 3),
                                  protocol_finalize=True)
    try:
        assert pc.warmup() == 3
        futs = [pc.submit(w, "translate", on_draft=drafts.append)
                for w in reqs[:4]]
        finals = [f.result(timeout=120) for f in futs]
        # close right after submitting: every future still resolves
        late = [pc.submit(w, "translate") for w in reqs[4:6]]
    finally:
        pc.close()
    assert [f.result(timeout=1) for f in late] == \
        [port.translate([w])[0] for w in reqs[4:6]]
    assert finals == [port.translate([w])[0] for w in reqs[:4]]
    assert len(drafts) == 4
    stats = pc.stats()
    assert stats["finalized"] == 6 and 0 <= stats["draft_exact"] <= 6


class _LateQueue(queue.Queue):
    """A queue whose first ``get`` with a timeout raises Empty although it
    holds an item: the finalizer's wait timed out just before the slot loop
    queued its last draft."""

    def __init__(self):
        super().__init__()
        self.first = True

    def get(self, block=True, timeout=None):
        if self.first and timeout is not None:
            self.first = False
            raise queue.Empty
        return super().get(block, timeout)


def test_finalizer_drains_a_draft_queued_as_the_loop_exits():
    """The interleaving of the shutdown race, forced: the finalizer's wait
    times out, the slot loop queues its last draft and exits, the
    finalizer then sees "closing and the loop dead". It must finalize the
    draft, not return and leave close() to fail it."""
    class Engine:
        def translate(self, wavs, source_lang=None, target_lang=None):
            return [f"final {len(w)}" for w in wavs]

    cont = ContinuousBatchingEngine.__new__(ContinuousBatchingEngine)
    cont.engine = Engine()
    cont._final_q = _LateQueue()
    cont._closing = threading.Event()
    cont._closing.set()
    cont._worker = threading.Thread(target=lambda: None)
    cont._worker.start()
    cont._worker.join()
    cont._lock = threading.Lock()
    cont._stats = {"finalized": 0, "draft_exact": 0}
    req = type("Req", (), {})()
    req.wav, req.source_lang, req.target_lang = np.zeros(5), "es", "en"
    req.future = Future()
    cont._final_q.put((req, "draft"))
    cont._finalize_loop()
    assert req.future.result(timeout=0) == "final 5"
    assert cont._stats == {"finalized": 1, "draft_exact": 0}


def test_refuses_what_it_cannot_serve(served):
    from stac_st_tpu_torch.parallel.mesh import make_mesh

    _, port, _, _ = served
    port.mesh = make_mesh(2, ("cpu", "cpu"))
    try:
        with pytest.raises(ValueError, match="multiple of the mesh"):
            ContinuousBatchingEngine(port, slots=3)
    finally:
        port.mesh = None
    pc = ContinuousBatchingEngine(port, slots=2, chunk=2)
    try:
        with pytest.raises(ValueError, match="speaker_turns"):
            pc.submit(np.zeros(100, np.float32), "speaker_turns")
    finally:
        pc.close()
    with pytest.raises(RuntimeError, match="closed"):
        pc.submit(np.zeros(100, np.float32))
