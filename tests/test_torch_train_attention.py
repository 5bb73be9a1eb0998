"""The four flash-attention kernels of the port (forward, training forward,
dQ, dK/dV).

On the CPU: the plain versions (what the wrappers run for CPU tensors)
against the JAX Pallas kernels in interpret mode, fp32, atol 1e-5, at
(B2, T24, H2, Dh8) (one logical tile) and (B1, T600, H1, Dh8) (five
128-row tiles, so the tile coordinates of the dropout hash move), with a
padded key row, dropout off and at p 0.25 with the same seed; the hash
itself bit for bit; and the autograd function's backward against autograd
of dense attention.

On the CPU too: the dispatch rule of the three training kernels as a pure
function of (dtype, head dim), and that each launcher passes it to the
library and counts its launch by it (a stand-in library records the
calls).

On a card (marked ``cuda``, skipped without one): each CUDA kernel against
its plain version on the same inputs, fp32 with TF32 off (atol 5e-5: sums
of a few hundred products in another order) and bf16 (atol 2e-2: both
store in bf16, one step is 2^-7 near 1, P and dS are rounded to bf16
before the products that take them in the tensor-core kernels, and the
backward sums bf16-rounded inputs), with a batch row whose keys are all
masked and query and key counts around the 64-row tiles of the
tensor-core kernels; which kernel each (dtype, head dim) launched, for
the forward, dQ and dK/dV; and that two launches of the backward on the
same inputs give bitwise-equal gradients. The card tests need no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_train_attention.py
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

from stac_st_tpu_torch.device import set_tf32
from stac_st_tpu_torch.ops import kernels
from stac_st_tpu_torch.ops.kernels import attention as A
from stac_st_tpu_torch.ops.kernels import train_attention as K

ATOL = 1e-5
NEG_INF = -1e9
SEED = 1234567
SHAPES = {"single_tile": (2, 24, 2, 8), "multi_tile": (1, 600, 1, 8)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(shape, seed=0):
    B, T, H, Dh = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, Dh)).astype(np.float32)
                  for _ in range(4))
    lens = np.asarray([T, max(T // 2 + 3, 1)][:B])
    lens[-1] = T - T // 3  # the last row pads its keys
    bias = np.where(np.arange(T)[None, :] < lens[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    return q, k, v, bias, g


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_train(shape, p_drop):
    """JAX forward (O, L) and backward (dQ, dK, dV) in interpret mode,
    through the custom VJP's own forward and backward rules."""
    import jax.numpy as jnp
    from stac_st_tpu.ops.pallas import train_attention as ref

    q, k, v, bias, g = (jnp.asarray(x) for x in _inputs(shape))
    seed = jnp.asarray(SEED, jnp.int32)
    out, res = ref._fat_fwd(q, k, v, bias, seed, p_drop, True)
    dq, dk, dv, _, _ = ref._fat_bwd(p_drop, True, res, g)
    B, T, H, _ = shape
    lse = np.asarray(res[6])[:, 0, :T].reshape(B, H, T)
    return [np.asarray(x) for x in (out, dq, dk, dv)] + [lse]


@pytest.mark.parametrize("p_drop", [0.0, 0.25])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_train_plain_versions_match_pallas(shape, p_drop):
    out_j, dq_j, dk_j, dv_j, lse_j = _jax_train(SHAPES[shape], p_drop)
    q, k, v, bias, g = _t(*_inputs(SHAPES[shape]))
    out, lse = K.flash_attention_train_fwd_ref(q, k, v, bias, SEED, p_drop)
    np.testing.assert_allclose(out.numpy(), out_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=ATOL, rtol=1e-6)
    delta = K.row_delta(g, out)
    dq = K.flash_attention_train_dq_ref(q, k, v, bias, SEED, p_drop, g, lse,
                                        delta)
    dk, dv = K.flash_attention_train_dkv_ref(q, k, v, bias, SEED, p_drop, g,
                                             lse, delta)
    for got, want, label in ((dq, dq_j, "dq"), (dk, dk_j, "dk"),
                             (dv, dv_j, "dv")):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                   err_msg=label)
    # the autograd function runs the same plain versions on CPU tensors
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    kernels.reset_launches()
    o = K.flash_attention_train(qa, ka, va, bias, SEED, p_drop)
    o.backward(g)
    assert sum(kernels.launches.values()) == 0
    torch.testing.assert_close(o, out, atol=0, rtol=0)
    torch.testing.assert_close(qa.grad, dq, atol=0, rtol=0)
    torch.testing.assert_close(ka.grad, dk, atol=0, rtol=0)
    torch.testing.assert_close(va.grad, dv, atol=0, rtol=0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_inference_plain_version_matches_pallas(shape):
    import jax.numpy as jnp
    from stac_st_tpu.ops.pallas.attention import flash_attention

    q, k, v, bias, _ = _inputs(SHAPES[shape])
    for b in (bias, None):
        want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if b is None else jnp.asarray(b),
                               interpret=True)
        got = A.flash_attention_ref(*_t(q, k, v),
                                    None if b is None else _t(b)[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("bh,qt,kt", [(0, 0, 0), (5, 2, 3), (127, 9, 1)])
def test_dropout_hash_is_the_reference_counter_path(bh, qt, kt):
    import jax.numpy as jnp
    from stac_st_tpu.ops.pallas.train_attention import _dropout_mask

    p_drop, shape = 0.25, (128, 128)
    for seed in (SEED, -7):  # a negative int32 seed wraps as in uint32
        want = np.asarray(_dropout_mask(
            jnp.asarray([seed], jnp.int32), jnp.int32(bh), jnp.int32(qt),
            jnp.int32(kt), p_drop, shape))
        row = torch.arange(shape[0])[:, None]
        col = torch.arange(shape[1])[None, :]
        x = K.tile_hash(seed, torch.tensor(bh), torch.tensor(qt),
                        torch.tensor(kt), row, col)
        assert int(x.min()) >= 0 and int(x.max()) <= 0xFFFFFFFF
        keep = (x >= int(p_drop * 2 ** 32)).numpy()
        np.testing.assert_array_equal(want > 0, keep)
        np.testing.assert_array_equal(
            want, keep.astype(np.float32) / np.float32(1.0 - p_drop))
        assert 0.2 < 1.0 - keep.mean() < 0.3


def test_dropout_keep_uses_the_logical_tiling():
    """A (B1, H1, 600, 600) mask equals the per-tile counter hash at the
    reference's 128-row tiles."""
    p_drop = 0.25
    full = K.dropout_keep(SEED, 1, 1, 600, 600, p_drop)[0, 0]
    assert K.tile_rows(600) == 128 and K.tile_rows(24) == 24
    r, c = torch.arange(128)[:, None], torch.arange(128)[None, :]
    x = K.tile_hash(SEED, torch.tensor(0), torch.tensor(2), torch.tensor(4),
                    r, c)
    tile = (x >= int(p_drop * 2 ** 32)).float() / np.float32(1 - p_drop)
    torch.testing.assert_close(full[256:384, 512:600], tile[:, :88],
                               atol=0, rtol=0)


def test_autograd_matches_dense_attention():
    q, k, v, bias, g = _t(*_inputs(SHAPES["single_tile"], seed=3))
    grads = []
    for fused in (True, False):
        qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
        if fused:
            o = K.flash_attention_train(qa, ka, va, bias)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", qa, ka) / np.sqrt(8.0)
            w = torch.softmax(s + bias[:, None, None, :], dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", w, va)
        o.backward(g)
        grads.append((o.detach(), qa.grad, ka.grad, va.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_wrappers_reject_unsupported_inputs():
    q = torch.zeros(1, 4, 1, 12)
    with pytest.raises(ValueError, match="head dim"):
        K.check("x", q, q, q, None)
    q = torch.zeros(1, 4, 1, 8, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        K.check("x", q, q, q, None)
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(TypeError, match="bias"):
        K.check("x", q, q, q, torch.zeros(1, 4, dtype=torch.float64))


class _Library:
    """Stands in for the kernel library: records each entry point's last
    ``use_tc`` argument and reports success."""

    def __init__(self):
        self.use_tc = {}

    def __getattr__(self, entry):
        def call(*args):
            self.use_tc[entry] = args[-1]
            return 0
        return call


def test_forward_dispatch_rule(monkeypatch):
    """bf16 and fp16 at Dh 64 go to the tensor-core kernels; fp32 (held to
    the CPU at 1e-5) and every other head dim to the CUDA-core ones. The
    forward, dQ and dK/dV launchers all ask the library for the kernel of
    that one rule and count the launch under it."""
    for dtype in (torch.bfloat16, torch.float16):
        assert K.flash_variant(dtype, 64) == "wgmma"
        for dh in (8, 32, 56, 72, 128):
            assert K.flash_variant(dtype, dh) == "simt"
    for dh in (8, 32, 64, 128):
        assert K.flash_variant(torch.float32, dh) == "simt"
    fake = _Library()
    monkeypatch.setattr(K, "lib", lambda: fake)
    monkeypatch.setattr(K, "stream", lambda: 0)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for dh in (32, 64):
            q = torch.zeros(1, 3, 2, dh, dtype=dtype)
            stats = torch.zeros(1, 2, 3)
            kernels.reset_launches()
            K.launch_fwd("flash_attention_train_fwd", q, q, q, None, True,
                         1.0, SEED, 0.1)
            K.launch_dq(q, q, q, None, SEED, 0.1, q, stats, stats)
            K.launch_dkv(q, q, q, None, SEED, 0.1, q, stats, stats)
            variant = K.flash_variant(dtype, dh)
            want = int(variant == "wgmma")
            assert fake.use_tc == {"stac_flash_fwd": want,
                                   "stac_flash_dq": want,
                                   "stac_flash_dkv": want}
            names = ("flash_attention_train_fwd", "flash_attention_train_dq",
                     "flash_attention_train_dkv")
            assert kernels.launches == {
                **{n: 1 for n in names},
                **{f"{n}/{variant}": 1 for n in names}}


# ---------------------------------------------- CUDA kernels vs plain ones
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    set_tf32(False)
    return torch.device("cuda")


_DTYPES = {"float32": (torch.float32, 5e-5),
           "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("p_drop", [0.0, 0.1])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("Tq,Tk", [(150, 150), (40, 150), (600, 600),
                                   (1, 150), (63, 65), (65, 150)])
def test_train_kernels_match_plain_on_card(card, dtype, p_drop, Tq, Tk):
    dt, tol = _DTYPES[dtype]
    rng = np.random.default_rng(5)
    B, H, Dh = 4, 4, 64
    q = torch.from_numpy(rng.standard_normal((B, Tq, H, Dh),
                                             dtype=np.float32)).to(card, dt)
    k, v = (torch.from_numpy(rng.standard_normal((B, Tk, H, Dh),
                                                 dtype=np.float32)).to(card, dt)
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((B, Tq, H, Dh),
                                             dtype=np.float32)).to(card, dt)
    lens = torch.tensor([Tk, Tk // 2, 7, 0], device=card)  # row 3: all masked
    bias = torch.where(torch.arange(Tk, device=card)[None, :] < lens[:, None],
                       0.0, NEG_INF).float()
    out, lse = K.flash_attention_train_fwd(q, k, v, bias, SEED, p_drop)
    ref, lse_ref = K.flash_attention_train_fwd_ref(q, k, v, bias, SEED,
                                                   p_drop)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=1e-5)
    delta = K.row_delta(g, ref)
    args = (q, k, v, bias, SEED, p_drop, g, lse_ref, delta)
    dq, (dk, dv) = K.flash_attention_train_dq(*args), \
        K.flash_attention_train_dkv(*args)
    torch.cuda.synchronize()
    dq_r = K.flash_attention_train_dq_ref(*args)
    dk_r, dv_r = K.flash_attention_train_dkv_ref(*args)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=tol * scale, rtol=0)
    o = A.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), A.flash_attention_ref(
        q, k, v, bias).float(), atol=tol, rtol=0)


def _card_inputs(card, dt, B, H, Tq, Tk, Dh, seed):
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.standard_normal((B, Tq, H, Dh),
                                                 dtype=np.float32)).to(card, dt)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Tk, H, Dh),
                                                 dtype=np.float32)).to(card, dt)
            for _ in range(2))
    bias = torch.where(torch.arange(Tk, device=card)[None, :]
                       < torch.tensor([Tk, 50], device=card)[:, None],
                       0.0, NEG_INF).float()
    return q, k, v, bias, g


@pytest.mark.cuda
@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_forward_dispatch_on_card(card, dtype, Dh):
    """Each launch of the forward, dQ and dK/dV went through the kernel the
    rule names, and that kernel matches the plain version (fp16: one step
    is 2^-10 near 1, P and dS rounded to fp16 before the products that take
    them; gradients relative to max(1, |plain|), as above)."""
    dt, tol = {"float32": (torch.float32, 5e-5),
               "bfloat16": (torch.bfloat16, 2e-2),
               "float16": (torch.float16, 1e-2)}[dtype]
    q, k, v, bias, g = _card_inputs(card, dt, 2, 4, 97, 130, Dh, 6)
    variant = K.flash_variant(dt, Dh)
    assert variant == ("wgmma" if dt != torch.float32 and Dh == 64
                       else "simt")
    kernels.reset_launches()
    out, lse = K.flash_attention_train_fwd(q, k, v, bias, SEED, 0.1)
    o = A.flash_attention(q, k, v, bias)
    ref, lse_ref = K.flash_attention_train_fwd_ref(q, k, v, bias, SEED, 0.1)
    args = (q, k, v, bias, SEED, 0.1, g, lse_ref, K.row_delta(g, ref))
    dq = K.flash_attention_train_dq(*args)
    dk, dv = K.flash_attention_train_dkv(*args)
    torch.cuda.synchronize()
    names = ("flash_attention_train_fwd", "flash_attention",
             "flash_attention_train_dq", "flash_attention_train_dkv")
    assert kernels.launches == {**{n: 1 for n in names},
                                **{f"{n}/{variant}": 1 for n in names}}
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=1e-5)
    torch.testing.assert_close(o.float(), A.flash_attention_ref(
        q, k, v, bias).float(), atol=tol, rtol=0)
    dk_r, dv_r = K.flash_attention_train_dkv_ref(*args)
    for got, want in ((dq, K.flash_attention_train_dq_ref(*args)),
                      (dk, dk_r), (dv, dv_r)):
        scale = max(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=tol * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_backward_kernels_are_deterministic_on_card(card, dtype):
    """Each block owns its output rows (no atomics): two launches of dQ and
    of dK/dV on the same inputs give bitwise-equal gradients."""
    dt = getattr(torch, dtype)
    q, k, v, bias, g = _card_inputs(card, dt, 2, 4, 301, 260, 64, 7)
    out, lse = K.flash_attention_train_fwd(q, k, v, bias, SEED, 0.1)
    args = (q, k, v, bias, SEED, 0.1, g, lse, K.row_delta(g, out))
    kernels.reset_launches()
    first = (K.flash_attention_train_dq(*args),
             *K.flash_attention_train_dkv(*args))
    second = (K.flash_attention_train_dq(*args),
              *K.flash_attention_train_dkv(*args))
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention_train_dq/wgmma"] == 2
    assert kernels.launches["flash_attention_train_dkv/wgmma"] == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
