"""The three decode-attention kernels of the port.

On the CPU: each plain version (``*_ref``, what the wrappers run for CPU
tensors) against its JAX Pallas kernel in interpret mode, fp32, atol 1e-4;
S is not a multiple of 128, with a padding bias, at beam 1 and beam 4, and
with a non-identity ancestor table.

On a card (marked ``cuda``, skipped without one): each CUDA kernel against
its plain version on the same inputs, in fp32 (TF32 off; atol 5e-5: the
kernel sums up to 251 products in another order, ~n·2^-24) and bf16 (atol
1e-2: both store in bf16, whose step is 2^-7 for |x| in [1, 2)); the
self kernel at the cache segments' S (67, 131, 195) and a longer cache,
1, 2 and 16 rows, with NaN past idx, on ``split`` (bf16, fp16) and
``simt`` (fp32); the anc
and cross ``split`` kernels (bf16 and fp16) also at beam 1, 4, 10 and 16,
over 1, 63, 64, 65 and 195 positions and S not a multiple of their tiles
(cross up to 751 keys, several tiles a block), with biases that mask whole
splits or a whole row, an out-of-range ancestor, the dual search's B32,
and two launches bitwise equal. fp16 is held to the bf16 tolerance (1e-2:
its outputs differ from the plain version's by the store's rounding and,
in cross, P's as two fp16 terms, both finer than bf16's). The card tests
need no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (this worker's share of the cores)

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


def test_decode_variant_rule(monkeypatch):
    """One rule picks the self, anc and cross kernel, from the dtype alone;
    the launchers hand it to the library and count the launch by variant
    (driven here with a stand-in for the library)."""
    assert K.decode_variant(torch.bfloat16) == "split"
    assert K.decode_variant(torch.float16) == "split"
    assert K.decode_variant(torch.float32) == "simt"
    monkeypatch.setattr(K, "_stream", lambda: 0)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    kernels.reset_launches()
    for dt, split in ((torch.bfloat16, 1), (torch.float16, 1),
                      (torch.float32, 0)):
        K._launch(None, "decode_cross_attention", entry, dt, 7)
        assert calls[-1] == (7, K._DTYPES[dt], split, 0)
    assert kernels.launches == {"decode_cross_attention": 3,
                                "decode_cross_attention/split": 2,
                                "decode_cross_attention/simt": 1}
    # the self launcher, whole: checks, output, the library call, counts
    monkeypatch.setattr(K, "_lib", lambda: SimpleNamespace(
        stac_decode_head_dim=lambda: 64, stac_decode_self_attention=entry))
    kernels.reset_launches()
    for dt, split in ((torch.bfloat16, 1), (torch.float16, 1),
                      (torch.float32, 0)):
        q = torch.zeros(2, 4, 64, dtype=dt)
        kT, v = torch.zeros(2, 4, 64, 5, dtype=dt), torch.zeros(2, 4, 5, 64,
                                                                 dtype=dt)
        out = K._launch_self(q, kT, v, 3)
        assert out.shape == q.shape and out.dtype == dt
        assert calls[-1][:4] == (q.data_ptr(), kT.data_ptr(), v.data_ptr(),
                                 out.data_ptr())
        assert calls[-1][4:] == (2, 4, 5, 3, K._DTYPES[dt], split, 0)
    assert kernels.launches == {"decode_self_attention": 3,
                                "decode_self_attention/split": 2,
                                "decode_self_attention/simt": 1}
    kernels.reset_launches()


def test_ragged_self_launcher_counts_rows(monkeypatch):
    """The ragged form (a (BB,) int32 index tensor) goes to its own entry
    point with the index array's address and S, no host index; it is
    counted under the name, the variant, ``/rows`` and ``/rows/<variant>``
    (driven with a stand-in for the library)."""
    monkeypatch.setattr(K, "_stream", lambda: 0)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(K, "_lib", lambda: SimpleNamespace(
        stac_decode_head_dim=lambda: 64,
        stac_decode_self_attention_rows=entry))
    kernels.reset_launches()
    for dt, split in ((torch.bfloat16, 1), (torch.float32, 0)):
        q = torch.zeros(3, 4, 64, dtype=dt)
        kT, v = torch.zeros(3, 4, 64, 5, dtype=dt), torch.zeros(3, 4, 5, 64,
                                                                 dtype=dt)
        idx = torch.tensor([0, 4, 9], dtype=torch.int32)
        out = K._launch_self(q, kT, v, idx)
        assert out.shape == q.shape
        assert calls[-1] == (q.data_ptr(), kT.data_ptr(), v.data_ptr(),
                             idx.data_ptr(), out.data_ptr(), 3, 4, 5,
                             K._DTYPES[dt], split, 0)
        with pytest.raises(TypeError, match="idx"):
            K._launch_self(q, kT, v, idx.long())
        with pytest.raises(ValueError, match="idx"):
            K._launch_self(q, kT, v, idx[:2])
    assert kernels.launches == {
        "decode_self_attention": 2, "decode_self_attention/split": 1,
        "decode_self_attention/simt": 1, "decode_self_attention/rows": 2,
        "decode_self_attention/rows/split": 1,
        "decode_self_attention/rows/simt": 1}
    kernels.reset_launches()


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


# ------------------------------------------- split kernels (bf16 / fp16)
_SPLIT = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_SPLIT_TOL = 1e-2


def _launched(name, fn, variant="split"):
    """fn's result; the launches it added must be one under name and one
    under ``variant`` (by default the kernel went through ``split``)."""
    before = dict(kernels.launches)
    out = fn()
    torch.cuda.synchronize()
    added = {k: n - before.get(k, 0) for k, n in kernels.launches.items()
             if n != before.get(k, 0)}
    assert added == {name: 1, f"{name}/{variant}": 1}, added
    return out


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=_SPLIT_TOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_SPLIT))
@pytest.mark.parametrize("beam", [1, 4, 10, 16])
def test_split_cross_kernel_matches_plain_on_card(card, rng, dtype, beam):
    dt = _SPLIT[dtype]
    for S in (1, 63, 64, 65, 195, 251, 300, 751):  # 751: 3 tiles a block
        q, kT, v, _ = _cross_inputs(rng, B=3, beam=beam, S=S, pad=False)
        q, kT, v = _on(card, dt, q, kT, v)
        ar = torch.arange(S, device=card)[None, :]
        biases = {
            "none": None,
            # keys 0..39 only: every 32-key split past the second is masked
            "splits": torch.where(ar < torch.tensor([[S], [40], [7]],
                                                    device=card), 0.0, -1e9),
            # row 1 has no key at all: the plain version's uniform softmax
            "row": torch.where(ar < torch.tensor([[S], [0], [S // 2 + 1]],
                                                 device=card), 0.0, -1e9),
        }
        for label, bias in biases.items():
            bias = None if bias is None else bias.float().contiguous()
            out = _launched("decode_cross_attention", lambda: (
                K.decode_cross_attention(q, kT, v, bias, beam)))
            ref = K.decode_cross_attention_ref(q, kT, v, bias, beam)
            assert torch.isfinite(out).all(), (S, label)
            _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("beam", [1, 3])
def test_cross_kernel_at_slot_loop_shapes_on_card(card, rng, dtype, beam):
    """Continuous batching's cross-attention: 16 slots padded to 801
    encoder frames (the 32 s bucket), each masked past floor(rel · S_w) of
    its own bucket as admission builds the bias; beam 1 (the chunk step)
    and 3 (prompt priming). ``simt`` for fp32, ``split`` for bf16, which
    gives the same bits over two launches."""
    dt, tol = _DTYPES[dtype]
    S, R = 801, 16
    seconds = np.asarray([0.4, 2.0, 2.7, 3.1, 4.0, 5.5, 8.0, 9.9, 12.3, 16.0,
                          17.2, 20.0, 24.5, 28.0, 31.0, 32.0])
    bucket = np.asarray([min(b for b in (2.0, 4.0, 8.0, 16.0, 32.0)
                             if b >= s) for s in seconds])
    abs_len = np.floor(seconds / bucket * (25 * bucket + 1))
    bias = np.where(np.arange(S)[None, :] > abs_len[:, None], NEG_INF,
                    0.0).astype(np.float32)
    q, kT, v, _ = _cross_inputs(rng, B=R, beam=beam, H=4, S=S, pad=False)
    q, kT, v = _on(card, dt, q, kT, v)
    bias = torch.from_numpy(bias).to(card)
    variant = K.decode_variant(dt)
    outs = [_launched("decode_cross_attention", lambda: (
        K.decode_cross_attention(q, kT, v, bias, beam)), variant)
        for _ in range(2)]
    ref = K.decode_cross_attention_ref(q, kT, v, bias, beam)
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                               rtol=0)
    if variant == "split":
        assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_SPLIT))
@pytest.mark.parametrize("beam", [1, 4, 10, 16])
def test_split_anc_kernel_matches_plain_on_card(card, rng, dtype, beam):
    dt = _SPLIT[dtype]
    S = 200  # a cache not a multiple of the 8-position tile
    q, k, v, anc = _anc_inputs(rng, B=3, beam=beam, S=S)
    q, k, v = _on(card, dt, q, k, v)
    anc = torch.from_numpy(anc).to(card)
    for n in (1, 63, 64, 65, 195, S):
        idx = n - 1
        out = _launched("decode_self_attention_anc", lambda: (
            K.decode_self_attention_anc(q, k, v, anc, idx, beam)))
        _close(out, K.decode_self_attention_anc_ref(q, k, v, anc, idx, beam))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_SPLIT))
def test_split_anc_out_of_range_ancestor_on_card(card, rng, dtype):
    """An ancestor outside [0, beam) selects no key: at the last position
    that is attention over positions 0..idx-1."""
    dt, beam, S, idx = _SPLIT[dtype], 10, 131, 97
    q, k, v, anc = _anc_inputs(rng, B=2, beam=beam, S=S)
    q, k, v = _on(card, dt, q, k, v)
    anc = torch.from_numpy(anc).to(card)
    bad = anc.clone()
    bad[0, 3, idx], bad[1, 0, idx], bad[1, 9, idx] = beam, -1, 1 << 30
    out = _launched("decode_self_attention_anc", lambda: (
        K.decode_self_attention_anc(q, k, v, bad, idx, beam)))
    hit = torch.zeros(2 * beam, dtype=torch.bool, device=card)
    hit[[3, beam, 2 * beam - 1]] = True
    _close(out[~hit], K.decode_self_attention_anc_ref(q, k, v, anc, idx,
                                                      beam)[~hit])
    _close(out[hit], K.decode_self_attention_anc_ref(q, k, v, anc, idx - 1,
                                                     beam)[hit])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_SPLIT))
def test_split_kernels_dual_search_shape_and_repeatable_on_card(card, rng,
                                                                 dtype):
    """B32 x beam 10 (the dual search tiles the encoder output), 251 frames
    and a 195-position cache; two launches give the same bits."""
    dt, B, beam = _SPLIT[dtype], 32, 10
    lens = rng.integers(1, 252, B)
    bias = np.where(np.arange(251)[None, :] < lens[:, None], 0.0,
                    NEG_INF).astype(np.float32)
    q = _randn(rng, B * beam, 2, 64) / 8.0
    kT, v = _randn(rng, B, 2, 64, 251), _randn(rng, B, 2, 251, 64)
    q, kT, v = _on(card, dt, q, kT, v)
    bias = torch.from_numpy(bias).to(card)
    cross = [_launched("decode_cross_attention", lambda: (
        K.decode_cross_attention(q, kT, v, bias, beam))) for _ in range(2)]
    _close(cross[0], K.decode_cross_attention_ref(q, kT, v, bias, beam))
    assert torch.equal(cross[0], cross[1])
    qa, ka, va, anc = _anc_inputs(rng, B=B, beam=beam, S=195)
    qa, ka, va = _on(card, dt, qa, ka, va)
    anc = torch.from_numpy(anc).to(card)
    outs = [_launched("decode_self_attention_anc", lambda: (
        K.decode_self_attention_anc(qa, ka, va, anc, 194, beam)))
        for _ in range(2)]
    _close(outs[0], K.decode_self_attention_anc_ref(qa, ka, va, anc, 194,
                                                    beam))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
# the cache segments; 1100: more tiles than 8 blocks of 4 warps, so
# warps walk several tiles
@pytest.mark.parametrize("S", [67, 131, 195, 1100])
def test_split_self_kernel_matches_plain_on_card(card, rng, dtype, S):
    """bf16 and fp16 on ``split`` (1e-2), fp32 on ``simt`` (5e-5), at 1, 2
    and 16 rows (beam 1: B1, B2, B16 greedy) and idx 0, 31, 32 (a tile's
    edge), 97 and S - 1. Positions past idx hold NaN in K and V: they take
    no weight and their V rows are never read, so the output equals the
    plain version's on the clean cache. Two launches give the same bits."""
    dt = getattr(torch, dtype)
    variant, tol = K.decode_variant(dt), 5e-5 if dtype == "float32" else 1e-2
    for rows in (1, 2, 16):
        q, kT, v = _self_inputs(rng, BB=rows, S=S)
        for idx in (i for i in (0, 31, 32, 97, S - 1) if i < S):
            kT_nan, v_nan = kT.copy(), v.copy()
            kT_nan[..., idx + 1:] = np.nan
            v_nan[:, :, idx + 1:] = np.nan
            qd, kd, vd = _on(card, dt, q, kT_nan, v_nan)
            outs = [_launched("decode_self_attention", lambda: (
                K.decode_self_attention(qd, kd, vd, idx)), variant)
                for _ in range(2)]
            ref = K.decode_self_attention_ref(*_on(card, dt, q, kT, v), idx)
            assert torch.isfinite(outs[0]).all(), (rows, idx)
            torch.testing.assert_close(outs[0].float(), ref.float(),
                                       atol=tol, rtol=0)
            assert torch.equal(outs[0], outs[1]), (rows, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("S", [13, 195, 1100])
def test_ragged_self_kernel_matches_plain_on_card(card, rng, dtype, S):
    """The ragged form: 16 rows, each at its own index (0, tile edges,
    mid, S - 1, and past S, which reads all S), on ``split`` (bf16, fp16)
    and ``simt`` (fp32). Positions past each row's index hold NaN (rows
    within the cache): no weight, never read. Two launches give the same
    bits; the launch is counted under ``/rows``."""
    dt = getattr(torch, dtype)
    variant, tol = K.decode_variant(dt), 5e-5 if dtype == "float32" else 1e-2
    rows = 16
    q, kT, v = _self_inputs(rng, BB=rows, S=S)
    idx = np.asarray([0, 31, 32, 63, S // 2, S - 1, S, S + 7, 3 * S,
                      1, 2, 97, 130, 194, 5, 64], np.int64)
    idx = np.minimum(idx, np.where(np.arange(rows) < 6, S - 1, 10 * S))
    idx = idx.astype(np.int32)
    kT_nan, v_nan = kT.copy(), v.copy()
    for r, i in enumerate(idx):
        kT_nan[r, ..., i + 1:] = np.nan
        v_nan[r, :, i + 1:] = np.nan
    qd, kd, vd = _on(card, dt, q, kT_nan, v_nan)
    idx_d = torch.from_numpy(idx).to(card)
    outs = []
    for _ in range(2):
        before = dict(kernels.launches)
        outs.append(K.decode_self_attention(qd, kd, vd, idx_d))
        torch.cuda.synchronize()
        added = {k: n - before.get(k, 0) for k, n in kernels.launches.items()
                 if n != before.get(k, 0)}
        name = "decode_self_attention"
        assert added == {name: 1, f"{name}/{variant}": 1, f"{name}/rows": 1,
                         f"{name}/rows/{variant}": 1}, added
    ref = K.decode_self_attention_ref(*_on(card, dt, q, kT, v), idx_d)
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                               rtol=0)
    assert torch.equal(outs[0], outs[1])
    # a row at a host index gives what the scalar form gives
    for r in (1, 4):
        one = K.decode_self_attention(qd[r:r + 1], kd[r:r + 1], vd[r:r + 1],
                                      int(idx[r]))
        torch.testing.assert_close(outs[0][r:r + 1].float(), one.float(),
                                   atol=tol, rtol=0)


# ---------------------------------------------- the int8 cache's kernels
def _int8_cache(rng, rows, S, H=4, Dh=64, unwritten=0):
    """int8 Kᵀ (rows, H, Dh, S) / V (rows, H, S, Dh) with their scales
    (rows, H, 1, S), quantized as the decode step appends them; the last
    ``unwritten`` positions left as an unwritten cache holds them (zeros,
    scale 0)."""
    from stac_st_tpu_torch.models.transformer import quantize_rows

    kT, ks = quantize_rows(torch.from_numpy(_randn(rng, rows, H, Dh, S)), 2)
    v, vs = quantize_rows(torch.from_numpy(_randn(rng, rows, H, S, Dh)), 3)
    vs = vs.transpose(2, 3).contiguous()
    if unwritten:
        for t in (kT, ks, vs):
            t[..., S - unwritten:] = 0
        v[:, :, S - unwritten:] = 0
    return kT, v, ks, vs


def test_int8_launchers_check_and_count(monkeypatch, rng):
    """The int8 wrappers hand the library their tensors' addresses (the
    ragged form its own entry point, no host index) and the variant of
    :func:`decode_variant` (``split`` for bf16, ``simt`` for fp32), and
    count each launch under the name and that variant (``/rows`` too for
    the ragged form); a float cache or a scale of another dtype raises (a
    stand-in for the library)."""
    monkeypatch.setattr(K, "_stream", lambda: 0)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(K, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(K, "_lib", lambda: SimpleNamespace(
        stac_decode_head_dim=lambda: 64, stac_decode_max_beam=lambda: 16,
        stac_decode_self_attention_int8=entry,
        stac_decode_self_attention_int8_rows=entry,
        stac_decode_cross_attention_int8=entry))
    kernels.reset_launches()
    kT, v, ks, vs = _int8_cache(rng, 3, 5)
    q = torch.zeros(3, 4, 64, dtype=torch.bfloat16)
    K.decode_self_attention_int8(q, kT, v, ks, vs, 2)
    assert calls[-1][-7:] == (3, 4, 5, 2, K._DTYPES[torch.bfloat16], 1, 0)
    idx = torch.tensor([0, 4, 9], dtype=torch.int32)
    K.decode_self_attention_int8(q, kT, v, ks, vs, idx)
    assert calls[-1][5] == idx.data_ptr() and calls[-1][-6:-3] == (3, 4, 5)
    assert calls[-1][-3:] == (K._DTYPES[torch.bfloat16], 1, 0)
    K.decode_cross_attention_int8(q, kT[:1], v[:1], ks[:1], vs[:1], None, 3)
    assert calls[-1][5] is None and calls[-1][-7:-3] == (1, 4, 5, 3)
    assert calls[-1][-3:] == (K._DTYPES[torch.bfloat16], 1, 0)
    q32 = q.float()
    K.decode_self_attention_int8(q32, kT, v, ks, vs, 2)
    assert calls[-1][-3:] == (K._DTYPES[torch.float32], 0, 0)
    name, cross = "decode_self_attention_int8", "decode_cross_attention_int8"
    assert kernels.launches == {
        name: 3, f"{name}/split": 2, f"{name}/simt": 1, f"{name}/rows": 1,
        f"{name}/rows/split": 1, cross: 1, f"{cross}/split": 1}
    with pytest.raises(TypeError, match="kT"):
        K.decode_self_attention_int8(q, kT.float(), v, ks, vs, 2)
    with pytest.raises(TypeError, match="k_scale"):
        K.decode_self_attention_int8(q, kT, v, ks.double(), vs, 2)
    with pytest.raises(ValueError, match="idx"):
        K.decode_self_attention_int8(q, kT, v, ks, vs, 5)
    kernels.reset_launches()


_ALL_DTYPES = {"float32": (torch.float32, 5e-5),
               "bfloat16": (torch.bfloat16, 1e-2),
               "float16": (torch.float16, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_ALL_DTYPES))
@pytest.mark.parametrize("S", [13, 195, 1100])
def test_int8_self_kernel_matches_plain_on_card(card, rng, dtype, S):
    """decode_self_attention_int8, scalar (idx S - 1 and mid-cache, the
    rest unwritten) and ragged (16 rows at their own indices, past S
    too): within ``_ALL_DTYPES``' tolerance of the plain version, two
    launches bitwise equal, counted by form."""
    dt, tol = _ALL_DTYPES[dtype]
    rows = 16
    kT, v, ks, vs = _int8_cache(rng, rows, S, unwritten=S // 3)
    q = torch.from_numpy(_randn(rng, rows, 4, 64))
    qd = q.to(card, dt)
    kd, vd, ksd, vsd = (t.to(card) for t in (kT, v, ks, vs))
    idx = np.asarray([0, 1, 31, 32, 63, 64, S // 2, S - 1, S, 3 * S, 5, 97,
                      130, 194, 2, S + 1], np.int64)
    idx = np.minimum(idx, np.where(np.arange(rows) < 8, S - 1, 10 * S))
    for at in (S - 1, S // 2, torch.from_numpy(idx.astype(np.int32))):
        at = at.to(card) if isinstance(at, torch.Tensor) else at
        outs = [K.decode_self_attention_int8(qd, kd, vd, ksd, vsd, at)
                for _ in range(2)]
        torch.cuda.synchronize()
        ref = K.decode_self_attention_int8_ref(qd, kd, vd, ksd, vsd, at)
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                                   rtol=0)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_ALL_DTYPES))
@pytest.mark.parametrize("beam", [1, 3, 10, 16])
@pytest.mark.parametrize("S", [251, 801])
def test_int8_cross_kernel_matches_plain_on_card(card, rng, dtype, beam, S):
    """decode_cross_attention_int8: B 4 utterances, with no bias and with a
    bias that masks a tail, most keys, and every key of one row (the
    reference's uniform softmax); two launches bitwise equal."""
    dt, tol = _ALL_DTYPES[dtype]
    B = 4
    kT, v, ks, vs = (t.to(card) for t in _int8_cache(rng, B, S))
    q = torch.from_numpy(_randn(rng, B * beam, 4, 64)).to(card, dt)
    lens = torch.tensor([S, S // 2, 7, 0], device=card)
    mask = torch.where(torch.arange(S, device=card)[None, :] < lens[:, None],
                       0.0, NEG_INF).float()
    for bias in (None, mask):
        outs = [K.decode_cross_attention_int8(q, kT, v, ks, vs, bias, beam)
                for _ in range(2)]
        torch.cuda.synchronize()
        ref = K.decode_cross_attention_int8_ref(q, kT, v, ks, vs, bias, beam)
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                                   rtol=0)
        assert torch.equal(outs[0], outs[1])


# ------------------------------ the int8 kernels' variants (split / simt)
def _int8_launched(name, fn, variant, form=""):
    """fn's result; its launches must be one under name and ``variant``
    (and ``form``, ``form/variant``)."""
    want = {name: 1, f"{name}/{variant}": 1}
    if form:
        want.update({f"{name}/{form}": 1, f"{name}/{form}/{variant}": 1})
    before = dict(kernels.launches)
    out = fn()
    torch.cuda.synchronize()
    added = {k: n - before.get(k, 0) for k, n in kernels.launches.items()
             if n != before.get(k, 0)}
    assert added == want, added
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_ALL_DTYPES))
# the cache segments; 1100: more tiles than 8 blocks of 4 warps
@pytest.mark.parametrize("S", [67, 131, 195, 1100])
def test_int8_split_self_kernel_on_card(card, rng, dtype, S):
    """decode_self_attention_int8's scalar form on ``split`` (bf16, fp16;
    1e-2) and ``simt`` (fp32; 5e-5) against the plain version, at 2, 16 and
    160 rows and n = idx + 1 of 1, of 41 and 97 (not multiples of 16) and
    of S; positions past n are an unwritten cache (zeros, scale 0) that
    takes no weight. Two launches give the same bits."""
    dt, tol = _ALL_DTYPES[dtype]
    variant, name = K.decode_variant(dt), "decode_self_attention_int8"
    for rows in (2, 16, 160):
        kT, v, ks, vs = (t.to(card) for t in _int8_cache(rng, rows, S))
        q = torch.from_numpy(_randn(rng, rows, 4, 64)).to(card, dt)
        for idx in (i for i in (0, 40, 96, S - 1) if i < S):
            kTu, vu, ksu, vsu = (t.clone() for t in (kT, v, ks, vs))
            for t in (kTu, ksu, vsu):
                t[..., idx + 1:] = 0
            vu[:, :, idx + 1:] = 0
            outs = [_int8_launched(name, lambda: K.decode_self_attention_int8(
                q, kTu, vu, ksu, vsu, idx), variant) for _ in range(2)]
            ref = K.decode_self_attention_int8_ref(q, kT, v, ks, vs, idx)
            assert torch.isfinite(outs[0]).all(), (rows, idx)
            torch.testing.assert_close(outs[0].float(), ref.float(),
                                       atol=tol, rtol=0)
            assert torch.equal(outs[0], outs[1]), (rows, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_ALL_DTYPES))
@pytest.mark.parametrize("S", [67, 195, 1100])
def test_int8_split_ragged_self_kernel_on_card(card, rng, dtype, S):
    """The ragged form on ``split`` / ``simt``: 16 rows at index 0, tile
    edges, S - 1, and at and past S (which reads all S), counted under
    ``/rows``; two launches bitwise equal; a row at a host index gives
    what the scalar form gives."""
    dt, tol = _ALL_DTYPES[dtype]
    variant, name = K.decode_variant(dt), "decode_self_attention_int8"
    rows = 16
    kT, v, ks, vs = (t.to(card) for t in _int8_cache(rng, rows, S))
    q = torch.from_numpy(_randn(rng, rows, 4, 64)).to(card, dt)
    idx = np.asarray([0, 31, 32, 40, S - 1, S, S + 7, 3 * S, 1, 63, 64, 96,
                      S // 2, 0, 5, 10 * S], np.int64)
    idx = np.minimum(idx, np.where(np.arange(rows) < 4, S - 1, 10 * S))
    at = torch.from_numpy(idx.astype(np.int32)).to(card)
    outs = [_int8_launched(name, lambda: K.decode_self_attention_int8(
        q, kT, v, ks, vs, at), variant, "rows") for _ in range(2)]
    ref = K.decode_self_attention_int8_ref(q, kT, v, ks, vs, at)
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol, rtol=0)
    assert torch.equal(outs[0], outs[1])
    for r in (0, 4, 13):
        one = K.decode_self_attention_int8(
            q[r:r + 1], kT[r:r + 1], v[r:r + 1], ks[r:r + 1], vs[r:r + 1],
            int(min(idx[r], S - 1)))
        torch.testing.assert_close(outs[0][r:r + 1].float(), one.float(),
                                   atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_ALL_DTYPES))
@pytest.mark.parametrize("beam", [1, 3, 10, 16])
@pytest.mark.parametrize("S", [251, 801])
def test_int8_split_cross_kernel_on_card(card, rng, dtype, beam, S):
    """decode_cross_attention_int8 on ``split`` (bf16, fp16) and ``simt``
    (fp32): 4 utterances, no bias, and a bias that masks a tail, most
    keys, and every key of one row; two launches bitwise equal."""
    dt, tol = _ALL_DTYPES[dtype]
    variant, name = K.decode_variant(dt), "decode_cross_attention_int8"
    B = 4
    kT, v, ks, vs = (t.to(card) for t in _int8_cache(rng, B, S))
    q = torch.from_numpy(_randn(rng, B * beam, 4, 64)).to(card, dt)
    lens = torch.tensor([S, S // 2, 7, 0], device=card)
    mask = torch.where(torch.arange(S, device=card)[None, :] < lens[:, None],
                       0.0, NEG_INF).float()
    for bias in (None, mask):
        outs = [_int8_launched(name, lambda: K.decode_cross_attention_int8(
            q, kT, v, ks, vs, bias, beam), variant) for _ in range(2)]
        ref = K.decode_cross_attention_int8_ref(q, kT, v, ks, vs, bias, beam)
        assert torch.isfinite(outs[0]).all()
        torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol,
                                   rtol=0)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(_ALL_DTYPES))
@pytest.mark.parametrize("beam", [1, 3])
def test_int8_cross_kernel_slot_loop_bias_on_card(card, rng, dtype, beam):
    """The slot loop's bias at 16 slots x 801 frames, which ``split`` reads
    first to skip the position tiles it masks whole: prefixes of the 2-32 s
    buckets, a free slot (every frame masked: the reference's uniform
    softmax, every tile read), a slot whose only visible frame is 0, one
    whose only visible frame is the last, and one with a visible frame
    inside an otherwise masked tile. Within tolerance of the plain
    version, two launches bitwise equal; and equal to the same call with
    the masked K/V filled with other values (a skipped tile counts for
    nothing)."""
    dt, tol = _ALL_DTYPES[dtype]
    variant, name = K.decode_variant(dt), "decode_cross_attention_int8"
    R, S = 16, 801
    lens = [20, 50, 67, 100, 137, 201, 250, 301, 401, 500, 601, 700, 801]
    bias = np.full((R, S), NEG_INF, np.float32)
    for r, n in enumerate(lens):
        bias[r, :n] = 0.0
    # row 13: every frame masked; 14: only frame 0; 15: only frame S - 1
    bias[14, 0] = 0.0
    bias[15, S - 1] = 0.0
    bias[2, 400] = -3.0  # one visible frame in a masked tile, off 0
    bias_d = torch.from_numpy(bias).to(card)
    kT, v, ks, vs = (t.to(card) for t in _int8_cache(rng, R, S))
    q = torch.from_numpy(_randn(rng, R * beam, 4, 64)).to(card, dt)
    outs = [_int8_launched(name, lambda: K.decode_cross_attention_int8(
        q, kT, v, ks, vs, bias_d, beam), variant) for _ in range(2)]
    ref = K.decode_cross_attention_int8_ref(q, kT, v, ks, vs, bias_d, beam)
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0].float(), ref.float(), atol=tol, rtol=0)
    assert torch.equal(outs[0], outs[1])
    hidden = torch.from_numpy(bias <= NEG_INF).to(card)
    hidden[13] = False  # the free slot reads every frame
    kT2, v2 = kT.clone(), v.clone()
    kT2.masked_fill_(hidden[:, None, None, :], 77)
    v2.masked_fill_(hidden[:, None, :, None], -77)
    other = K.decode_cross_attention_int8(q, kT2, v2, ks, vs, bias_d, beam)
    ref2 = K.decode_cross_attention_int8_ref(q, kT2, v2, ks, vs, bias_d, beam)
    torch.testing.assert_close(other.float(), ref2.float(), atol=tol, rtol=0)
    if variant == "split":
        assert torch.equal(other, outs[0])


@pytest.mark.cuda
def test_int8_split_entry_refuses_fp32_and_unaligned_on_card(card, rng):
    """No fallback: the library's split entry asked for fp32 returns
    ERR_VARIANT, and a tensor off 16 bytes makes the wrapper raise with
    ERR_ALIGN."""
    lib = K._lib()
    kT, v, ks, vs = (t.to(card) for t in _int8_cache(rng, 2, 67))
    q = torch.zeros(2, 4, 64, device=card)
    out = torch.empty_like(q)
    rc = lib.stac_decode_self_attention_int8(
        q.data_ptr(), kT.data_ptr(), v.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), out.data_ptr(), 2, 4, 67, 10,
        K._DTYPES[torch.float32], 1, K._stream())
    with pytest.raises(RuntimeError, match="split for bf16"):
        K._raise_on(lib, "decode_self_attention_int8", rc)
    qb = q.to(torch.bfloat16)
    flat = torch.zeros(kT.numel() + 1, dtype=torch.int8, device=card)
    off = flat[1:].view(kT.shape)
    off.copy_(kT)
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        K.decode_self_attention_int8(qb, off, v, ks, vs, 10)
    with pytest.raises(RuntimeError, match="16-byte aligned"):
        K.decode_cross_attention_int8(qb, off, v, ks, vs, None, 1)
