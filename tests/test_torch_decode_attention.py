"""The three decode-attention kernels of the port.

On the CPU: each plain version (``*_ref``, what the wrappers run for CPU
tensors) against its JAX Pallas kernel in interpret mode, fp32, atol 1e-4;
S is not a multiple of 128, with a padding bias, at beam 1 and beam 4, and
with a non-identity ancestor table.

On a card (marked ``cuda``, skipped without one): each CUDA kernel against
its plain version on the same inputs, in fp32 (TF32 off; atol 5e-5: the
kernel sums up to 251 products in another order, ~n·2^-24) and bf16 (atol
1e-2: both store in bf16, whose step is 2^-7 for |x| in [1, 2)). The card tests need no JAX,
so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py
"""

import numpy as np
import pytest
import torch

from stac_st_tpu_torch.device import set_tf32
from stac_st_tpu_torch.ops import kernels
from stac_st_tpu_torch.ops.kernels import decode_attention as K

ATOL = 1e-4
NEG_INF = -1e9


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(2024)


def _pallas():
    """The JAX Pallas kernels (imported here: the card tests need no JAX)."""
    import jax.numpy as jnp
    from stac_st_tpu.ops.pallas import decode_attention as pallas

    return jnp, pallas


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _self_inputs(rng, BB=6, H=4, Dh=64, S=40):
    q = _randn(rng, BB, H, Dh) / 8.0
    return q, _randn(rng, BB, H, Dh, S), _randn(rng, BB, H, S, Dh)


def _anc_inputs(rng, B=2, beam=4, H=2, Dh=64, S=40):
    q = _randn(rng, B * beam, H, Dh) / 8.0
    k, v = _randn(rng, B * beam, H, S, Dh), _randn(rng, B * beam, H, S, Dh)
    anc = rng.integers(0, beam, (B, beam, S)).astype(np.int32)
    return q, k, v, anc


def _cross_inputs(rng, B=3, beam=4, H=2, Dh=64, S=30, pad=True):
    q = _randn(rng, B * beam, H, Dh) / 8.0
    kT, v = _randn(rng, B, H, Dh, S), _randn(rng, B, H, S, Dh)
    bias = None
    if pad:
        lens = np.asarray([S, 20, 7][:B])
        bias = np.where(np.arange(S)[None, :] < lens[:, None], 0.0,
                        NEG_INF).astype(np.float32)
    return q, kT, v, bias


# ------------------------------------------------ plain versions vs Pallas
@pytest.mark.parametrize("S,idx", [(40, 17), (130, 129)])
def test_self_ref_matches_pallas(rng, S, idx):
    jnp, pallas = _pallas()
    q, kT, v = _self_inputs(rng, S=S)
    ref = pallas.decode_self_attention(
        jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v),
        jnp.asarray(idx, jnp.int32), interpret=True)
    got = K.decode_self_attention_ref(*_t(q, kT, v), idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("beam", [1, 4])
def test_anc_ref_matches_pallas(rng, beam):
    jnp, pallas = _pallas()
    q, k, v, anc = _anc_inputs(rng, beam=beam)
    if beam > 1:
        assert (anc != np.arange(beam)[None, :, None]).any()
    idx = 29
    ref = pallas.decode_self_attention_anc(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(anc),
        jnp.asarray(idx, jnp.int32), beam, interpret=True)
    got = K.decode_self_attention_anc_ref(*_t(q, k, v, anc), idx, beam)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("beam,pad", [(1, True), (4, True), (4, False)])
def test_cross_ref_matches_pallas(rng, beam, pad):
    jnp, pallas = _pallas()
    q, kT, v, bias = _cross_inputs(rng, beam=beam, pad=pad)
    ref = pallas.decode_cross_attention(
        jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), beam, interpret=True)
    got = K.decode_cross_attention_ref(
        *_t(q, kT, v), None if bias is None else _t(bias)[0], beam)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_wrappers_take_the_plain_version_on_cpu_tensors(rng):
    """CPU tensors go to the plain version, and that is no kernel launch."""
    kernels.reset_launches()
    q, kT, v = _t(*_self_inputs(rng))
    out = K.decode_self_attention(q, kT, v, 5)
    torch.testing.assert_close(out, K.decode_self_attention_ref(q, kT, v, 5))
    qa, ka, va, anc = _t(*_anc_inputs(rng))
    K.decode_self_attention_anc(qa, ka, va, anc, 5, 4)
    qc, kc, vc, bc = _t(*_cross_inputs(rng))
    K.decode_cross_attention(qc, kc, vc, bc, 4)
    assert sum(kernels.launches.values()) == 0


# ---------------------------------------------- CUDA kernels vs plain ones
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    set_tf32(False)
    return torch.device("cuda")


_DTYPES = {"float32": (torch.float32, 5e-5),
           "bfloat16": (torch.bfloat16, 1e-2)}


def _on(card, dtype, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(card, dtype)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_self_kernel_matches_plain_on_card(card, rng, dtype):
    dt, tol = _DTYPES[dtype]
    q, kT, v = _on(card, dt, *_self_inputs(rng, BB=20, S=195))
    before = kernels.launches.get("decode_self_attention", 0)
    out = K.decode_self_attention(q, kT, v, 150)
    torch.cuda.synchronize()
    assert kernels.launches["decode_self_attention"] == before + 1
    ref = K.decode_self_attention_ref(q, kT, v, 150)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_anc_kernel_matches_plain_on_card(card, rng, dtype):
    dt, tol = _DTYPES[dtype]
    q, k, v, anc = _anc_inputs(rng, B=4, beam=10, S=195)
    q, k, v = _on(card, dt, q, k, v)
    anc = torch.from_numpy(anc).to(card)
    out = K.decode_self_attention_anc(q, k, v, anc, 120, 10)
    torch.cuda.synchronize()
    ref = K.decode_self_attention_anc_ref(q, k, v, anc, 120, 10)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_cross_kernel_matches_plain_on_card(card, rng, dtype):
    dt, tol = _DTYPES[dtype]
    q, kT, v, bias = _cross_inputs(rng, B=3, beam=10, S=251)
    q, kT, v = _on(card, dt, q, kT, v)
    bias = torch.from_numpy(bias).to(card)
    for b in (bias, None):
        out = K.decode_cross_attention(q, kT, v, b, 10)
        torch.cuda.synchronize()
        ref = K.decode_cross_attention_ref(q, kT, v, b, 10)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
