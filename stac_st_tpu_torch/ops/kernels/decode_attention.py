"""Single-step decode attention: CUDA kernels and their plain versions.

Port of ``stac_st_tpu/ops/pallas/decode_attention.py``. Per (query row,
head), softmax(q · Kᵀ + mask) · V with a pre-scaled query, fp32
accumulation and the output in the query's dtype
(``csrc/decode_attention.cu``).

Each wrapper replaces one TPU kernel (``KERNELS`` below names it):

* ``decode_self_attention`` <- ``_self_kernel`` (decode_attention.py:30);
* ``decode_self_attention_anc`` <- ``_anc_kernel`` (:82);
* ``decode_cross_attention`` <- ``_cross_kernel`` (:159).

All three are bound by device memory: one step reads each cached key and
value once for 4·Dh flops per (query, position), about one flop per byte
in bf16. Each wrapper has two CUDA kernels, chosen by
:func:`decode_variant` (the only copy of the rule) from the dtype alone:
``split`` for bf16 and fp16 (each (utterance, head), for self each (row,
head), split over positions into a thread-block cluster, one pass, the
splits combined in the launch) and ``simt`` for fp32 (one block per (row,
head), two passes), which ``card_vs_cpu`` holds to the CPU at 1e-3.

``decode_self_attention`` also takes a per-row index (the ragged form
continuous batching steps with): an int32 tensor of one index per row, each
row attending to its positions ``0..min(idx[r], S - 1)``. Both kernels read
it on the device and size the launch on S, so the host reads no index.

Two kernels replace no TPU kernel: ``decode_self_attention_int8`` (also
in the ragged form) and ``decode_cross_attention_int8`` attend an int8
cache with one fp32 scale per (row, head, position) -- the reference's
XLA code in ``_step_int8`` (``stac_st_tpu/models/transformer.py:295``)
and ``_step_cross_int8`` (:508), whose int8 -> bf16 convert XLA fuses into
the matmul's operand load. In PyTorch that convert would read the int8
cache and write a copy in the query's dtype before the product read it
again: more bytes than the cache it replaces. Per (row, head): logit_p =
(q . k_p) * (k_scale_p / sqrt(Dh)) in fp32 from the unscaled query,
positions past the index (self) score -1e9, the bias (cross) is added,
softmax in fp32, w_p = softmax_p * v_scale_p rounded to q's dtype, and
out = sum w_p * v_p accumulated in fp32, stored in q's dtype. Their bound
is bytes: 2 * Dh int8 and 8 bytes of scales per position read, about 5.1
us for self at 160 rows x 195 positions (bf16: 9.6) and 0.65 us for cross
at B16 x 251 (bf16: 1.3), on an H100 at 3.35 TB/s. The same
:func:`decode_variant` picks their kernel: ``split`` for bf16 and fp16
splits each (row, head) -- each (utterance, head) for cross, whose beam
queries are the rows of one tensor-core product -- over positions in a
cluster, reads int8 in 16-byte chunks and keeps the reference's rounding
with an exact softmax across the cluster (each block keeps its logits;
the blocks exchange per-row maxima and sums before any weight is
formed); cross skips the K/V reads of position tiles its bias masks
whole. ``simt`` for fp32 is one block of 256 threads per (query row,
head), the scores in shared memory and an exact two-pass softmax.

A wrapper given CPU tensors returns its ``*_ref`` plain version. Given CUDA
tensors it checks dtype, shape and contiguity, launches the kernel on the
current stream, raises if the launch failed, and counts the launch under
``<name>`` and ``<name>/<variant>``, the kernel it asked the library to
launch; a ragged self launch also under ``<name>/rows`` and
``<name>/rows/<variant>``. There is no fallback from a CUDA tensor to the
plain version, nor from one kernel to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import count_launch, load_library

__all__ = [
    "decode_self_attention", "decode_self_attention_ref",
    "decode_self_attention_anc", "decode_self_attention_anc_ref",
    "decode_cross_attention", "decode_cross_attention_ref",
    "decode_self_attention_int8", "decode_self_attention_int8_ref",
    "decode_cross_attention_int8", "decode_cross_attention_int8_ref",
    "decode_variant", "KERNELS",
]

NEG_INF = -1e9
_LIB = "decode_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int

# name -> (TPU kernel it replaces, source of the Hopper kernel)
KERNELS = {
    "decode_self_attention": (
        "stac_st_tpu/ops/pallas/decode_attention.py:30",
        "stac_st_tpu_torch/csrc/decode_attention.cu"),
    "decode_self_attention_anc": (
        "stac_st_tpu/ops/pallas/decode_attention.py:82",
        "stac_st_tpu_torch/csrc/decode_attention.cu"),
    "decode_cross_attention": (
        "stac_st_tpu/ops/pallas/decode_attention.py:159",
        "stac_st_tpu_torch/csrc/decode_attention.cu"),
    "decode_self_attention_int8": (
        "none: the XLA dequant in stac_st_tpu/models/transformer.py:295 "
        "(_step_int8)",
        "stac_st_tpu_torch/csrc/decode_attention.cu"),
    "decode_cross_attention_int8": (
        "none: the XLA dequant in stac_st_tpu/models/transformer.py:508 "
        "(_step_cross_int8)",
        "stac_st_tpu_torch/csrc/decode_attention.cu"),
}


# ------------------------------------------------------------ plain versions
def _position_bias(S: int, idx, device) -> torch.Tensor:
    """(S,) for a host int ``idx``; (BB, 1, 1, S) for a (BB,) tensor."""
    pos = torch.arange(S, device=device)
    if isinstance(idx, torch.Tensor):
        pos = pos[None, None, None, :]
        idx = idx.to(device).reshape(-1, 1, 1, 1)
    return torch.where(pos > idx, NEG_INF, 0.0).to(torch.float32)


def decode_self_attention_ref(q, kT, v, idx):
    """q (BB, H, Dh) pre-scaled; kT (BB, H, Dh, S); v (BB, H, S, Dh);
    attend positions 0..idx. ``idx`` is a host int or a (BB,) integer
    tensor of one index per row (an index >= S sees all S positions).
    Returns (BB, H, Dh) in q's dtype."""
    s = torch.matmul(q.float()[:, :, None, :], kT.float())  # (BB, H, 1, S)
    s = s + _position_bias(kT.shape[-1], idx, q.device)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float())[:, :, 0, :].to(q.dtype)


def decode_self_attention_anc_ref(q, k, v, anc, idx: int, beam: int):
    """q (B·beam, H, Dh) pre-scaled; k/v (B·beam, H, S, Dh) never reordered;
    anc (B, beam, S) int32: hypothesis r reads position s from cache row
    b·beam + anc[b, r, s]. Explicit gather, then attention over 0..idx."""
    BB, H, Dh = q.shape
    S = k.shape[2]
    B = BB // beam
    rows = (torch.arange(B, device=q.device)[:, None, None] * beam
            + anc.long()).reshape(BB, S)
    cols = torch.arange(S, device=q.device)[None, :]
    kg = k.permute(0, 2, 1, 3)[rows, cols].permute(0, 2, 1, 3)  # (BB,H,S,Dh)
    vg = v.permute(0, 2, 1, 3)[rows, cols].permute(0, 2, 1, 3)
    s = torch.matmul(q.float()[:, :, None, :], kg.float().transpose(-1, -2))
    s = s + _position_bias(S, idx, q.device)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vg.float())[:, :, 0, :].to(q.dtype)


def decode_cross_attention_ref(q, kT, v, bias: Optional[torch.Tensor],
                               beam: int):
    """q (B·beam, H, Dh) pre-scaled; kT (B, H, Dh, S); v (B, H, S, Dh);
    bias (B, S) additive fp32 or None. Beam queries of utterance b attend
    to its K/V. Returns (B·beam, H, Dh) in q's dtype."""
    BB, H, Dh = q.shape
    B = kT.shape[0]
    qg = q.float().reshape(B, beam, H, Dh).transpose(1, 2)  # (B,H,beam,Dh)
    s = torch.matmul(qg, kT.float())  # (B, H, beam, S)
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.float())  # (B, H, beam, Dh)
    return out.transpose(1, 2).reshape(BB, H, Dh).to(q.dtype)


def _qk_scale(dh: int) -> float:
    """1/sqrt(Dh) as the reference computes it, in fp32."""
    return float(1.0 / torch.sqrt(torch.tensor(float(dh))))


def decode_self_attention_int8_ref(q, kT, v, k_scale, v_scale, idx):
    """q (BB, H, Dh) unscaled; kT (BB, H, Dh, S) and v (BB, H, S, Dh)
    int8; k_scale, v_scale (BB, H, 1, S) fp32; attend positions 0..idx
    (a host int, or a (BB,) integer tensor of one index per row as in
    :func:`decode_self_attention_ref`). Returns (BB, H, Dh) in q's
    dtype."""
    s = torch.matmul(q.float()[:, :, None, :], kT.float())  # (BB, H, 1, S)
    s = s * (k_scale * _qk_scale(q.shape[-1]))
    s = s + _position_bias(kT.shape[-1], idx, q.device)
    w = (torch.softmax(s, dim=-1) * v_scale).to(q.dtype)
    return torch.matmul(w.float(), v.float())[:, :, 0, :].to(q.dtype)


def decode_cross_attention_int8_ref(q, kT, v, k_scale, v_scale,
                                    bias: Optional[torch.Tensor], beam: int):
    """q (B·beam, H, Dh) unscaled; kT (B, H, Dh, S) and v (B, H, S, Dh)
    int8; k_scale, v_scale (B, H, 1, S) fp32; bias (B, S) additive fp32 or
    None. Returns (B·beam, H, Dh) in q's dtype."""
    BB, H, Dh = q.shape
    B = kT.shape[0]
    qg = q.float().reshape(B, beam, H, Dh).transpose(1, 2)  # (B,H,beam,Dh)
    s = torch.matmul(qg, kT.float()) * (k_scale * _qk_scale(Dh))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    w = (torch.softmax(s, dim=-1) * v_scale).to(q.dtype)
    out = torch.matmul(w.float(), v.float()).to(q.dtype)  # (B, H, beam, Dh)
    return out.transpose(1, 2).reshape(BB, H, Dh)


# ------------------------------------------------------------------ kernels
def _lib():
    lib = load_library(_LIB)
    if not getattr(lib, "_stac_bound", False):
        lib.stac_decode_self_attention.argtypes = [_P, _P, _P, _P, _I, _I, _I,
                                                   _I, _I, _I, _P]
        lib.stac_decode_self_attention_rows.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.stac_decode_self_attention_anc.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.stac_decode_cross_attention.argtypes = [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.stac_decode_self_attention_int8.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.stac_decode_self_attention_int8_rows.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.stac_decode_cross_attention_int8.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        for fn in (lib.stac_decode_self_attention,
                   lib.stac_decode_self_attention_rows,
                   lib.stac_decode_self_attention_anc,
                   lib.stac_decode_cross_attention,
                   lib.stac_decode_self_attention_int8,
                   lib.stac_decode_self_attention_int8_rows,
                   lib.stac_decode_cross_attention_int8,
                   lib.stac_decode_head_dim, lib.stac_decode_max_beam):
            fn.restype = _I
        lib.stac_decode_head_dim.argtypes = []
        lib.stac_decode_max_beam.argtypes = []
        lib.stac_cuda_error_string.argtypes = [_I]
        lib.stac_cuda_error_string.restype = ctypes.c_char_p
        lib._stac_bound = True
    return lib


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors
                                if t is not None}) != 1:
        raise ValueError(f"tensors must all be on one CUDA device or all on "
                         f"the CPU, got {sorted(devs)}")
    return False


def _check(lib, name: str, q, tensors, shapes, dtypes=None):
    """dtype, shape and contiguity of each of ``tensors``: int32 for
    ``anc`` and ``idx``, fp32 for ``bias``, ``dtypes[label]`` where given,
    else q's dtype."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if q.shape[-1] != lib.stac_decode_head_dim():
        raise ValueError(f"{name}: head dim {q.shape[-1]} != "
                         f"{lib.stac_decode_head_dim()}")
    for label, t in tensors.items():
        want_dtype = {"anc": torch.int32, "idx": torch.int32,
                      "bias": torch.float32, **(dtypes or {})
                      }.get(label, q.dtype)
        if t.dtype != want_dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, "
                            f"expected {want_dtype}")
        if tuple(t.shape) != tuple(shapes[label]):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[label])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _check_beam(lib, name: str, beam: int) -> None:
    if not 1 <= beam <= lib.stac_decode_max_beam():
        raise ValueError(f"{name}: beam {beam} outside "
                         f"[1, {lib.stac_decode_max_beam()}]")


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = lib.stac_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def decode_variant(dtype: torch.dtype) -> str:
    """The kernel that serves every decode-attention wrapper (self, anc,
    cross and the two int8 ones) for ``dtype`` on the card: ``split``
    (position splits in a cluster) for bf16 and fp16, ``simt`` (the
    two-pass kernels) for fp32."""
    return "split" if dtype in (torch.bfloat16, torch.float16) else "simt"


def _launch(lib, name: str, fn, dtype: torch.dtype, *args,
            form: str = "") -> None:
    """Call library entry point ``fn`` with ``args``, the dtype code and
    the variant of :func:`decode_variant`; raise if it failed, else count
    the launch (and, for a ``form`` such as ``rows``, under that form
    too)."""
    variant = decode_variant(dtype)
    _raise_on(lib, name, fn(*args, _DTYPES[dtype], int(variant == "split"),
                            _stream()))
    count_launch(name)
    count_launch(f"{name}/{variant}")
    if form:
        count_launch(f"{name}/{form}")
        count_launch(f"{name}/{form}/{variant}")


def decode_self_attention(q, kT, v, idx):
    """See :func:`decode_self_attention_ref`. ``idx`` is a host int in
    [0, S), or a (BB,) int32 tensor on q's device (the ragged form; each
    index >= 0)."""
    if _on_cpu(q, kT, v, idx if isinstance(idx, torch.Tensor) else None):
        return decode_self_attention_ref(q, kT, v, idx)
    return _launch_self(q, kT, v, idx)


def _launch_self(q, kT, v, idx):
    """Launch the self kernel of :func:`decode_variant` on CUDA tensors."""
    name = "decode_self_attention"
    lib = _lib()
    BB, H, Dh = q.shape
    S = kT.shape[-1]
    tensors = {"q": q, "kT": kT, "v": v}
    shapes = {"q": (BB, H, Dh), "kT": (BB, H, Dh, S), "v": (BB, H, S, Dh)}
    ragged = isinstance(idx, torch.Tensor)
    if ragged:
        tensors["idx"], shapes["idx"] = idx, (BB,)
    _check(lib, name, q, tensors, shapes)
    out = torch.empty_like(q)
    if ragged:
        _launch(lib, name, lib.stac_decode_self_attention_rows, q.dtype,
                q.data_ptr(), kT.data_ptr(), v.data_ptr(), idx.data_ptr(),
                out.data_ptr(), BB, H, S, form="rows")
        return out
    if not 0 <= idx < S:
        raise ValueError(f"{name}: idx {idx} outside [0, {S})")
    _launch(lib, name, lib.stac_decode_self_attention, q.dtype,
            q.data_ptr(), kT.data_ptr(), v.data_ptr(), out.data_ptr(),
            BB, H, S, int(idx))
    return out


def decode_self_attention_anc(q, k, v, anc, idx: int, beam: int):
    """See :func:`decode_self_attention_anc_ref`. ``idx`` is a host int."""
    if _on_cpu(q, k, v, anc):
        return decode_self_attention_anc_ref(q, k, v, anc, idx, beam)
    name = "decode_self_attention_anc"
    lib = _lib()
    BB, H, Dh = q.shape
    S = k.shape[2]
    _check_beam(lib, name, beam)
    if BB % beam:
        raise ValueError(f"{name}: {BB} rows not a multiple of beam {beam}")
    _check(lib, name, q, {"q": q, "k": k, "v": v, "anc": anc},
           {"q": (BB, H, Dh), "k": (BB, H, S, Dh), "v": (BB, H, S, Dh),
            "anc": (BB // beam, beam, S)})
    if not 0 <= idx < S:
        raise ValueError(f"{name}: idx {idx} outside [0, {S})")
    out = torch.empty_like(q)
    _launch(lib, name, lib.stac_decode_self_attention_anc, q.dtype,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), anc.data_ptr(),
            out.data_ptr(), BB, H, S, beam, int(idx))
    return out


def decode_cross_attention(q, kT, v, bias: Optional[torch.Tensor],
                           beam: int):
    """See :func:`decode_cross_attention_ref`."""
    if _on_cpu(q, kT, v, bias):
        return decode_cross_attention_ref(q, kT, v, bias, beam)
    name = "decode_cross_attention"
    lib = _lib()
    BB, H, Dh = q.shape
    B, S = kT.shape[0], kT.shape[-1]
    if BB != B * beam:
        raise ValueError(f"{name}: {BB} query rows != {B} x beam {beam}")
    _check_beam(lib, name, beam)
    tensors = {"q": q, "kT": kT, "v": v}
    shapes = {"q": (BB, H, Dh), "kT": (B, H, Dh, S), "v": (B, H, S, Dh)}
    if bias is not None:
        tensors["bias"], shapes["bias"] = bias, (B, S)
    _check(lib, name, q, tensors, shapes)
    out = torch.empty_like(q)
    _launch(lib, name, lib.stac_decode_cross_attention, q.dtype,
            q.data_ptr(), kT.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, S, beam)
    return out


# ---------------------------------------------------------- the int8 cache
_INT8 = {"kT": torch.int8, "v": torch.int8, "k_scale": torch.float32,
         "v_scale": torch.float32}


def decode_self_attention_int8(q, kT, v, k_scale, v_scale, idx):
    """See :func:`decode_self_attention_int8_ref`. ``idx`` is a host int
    in [0, S), or a (BB,) int32 tensor on q's device (the ragged form,
    counted under ``decode_self_attention_int8/rows`` too; each index
    >= 0)."""
    ragged = isinstance(idx, torch.Tensor)
    if _on_cpu(q, kT, v, k_scale, v_scale, idx if ragged else None):
        return decode_self_attention_int8_ref(q, kT, v, k_scale, v_scale,
                                              idx)
    name = "decode_self_attention_int8"
    lib = _lib()
    BB, H, Dh = q.shape
    S = kT.shape[-1]
    tensors = {"q": q, "kT": kT, "v": v, "k_scale": k_scale,
               "v_scale": v_scale}
    shapes = {"q": (BB, H, Dh), "kT": (BB, H, Dh, S), "v": (BB, H, S, Dh),
              "k_scale": (BB, H, 1, S), "v_scale": (BB, H, 1, S)}
    if ragged:
        tensors["idx"], shapes["idx"] = idx, (BB,)
    _check(lib, name, q, tensors, shapes, _INT8)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), kT.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr())
    if ragged:
        _launch(lib, name, lib.stac_decode_self_attention_int8_rows,
                q.dtype, *ptrs, idx.data_ptr(), out.data_ptr(), BB, H, S,
                form="rows")
        return out
    if not 0 <= idx < S:
        raise ValueError(f"{name}: idx {idx} outside [0, {S})")
    _launch(lib, name, lib.stac_decode_self_attention_int8, q.dtype,
            *ptrs, out.data_ptr(), BB, H, S, int(idx))
    return out


def decode_cross_attention_int8(q, kT, v, k_scale, v_scale,
                                bias: Optional[torch.Tensor], beam: int):
    """See :func:`decode_cross_attention_int8_ref`."""
    if _on_cpu(q, kT, v, k_scale, v_scale, bias):
        return decode_cross_attention_int8_ref(q, kT, v, k_scale, v_scale,
                                               bias, beam)
    name = "decode_cross_attention_int8"
    lib = _lib()
    BB, H, Dh = q.shape
    B, S = kT.shape[0], kT.shape[-1]
    if BB != B * beam:
        raise ValueError(f"{name}: {BB} query rows != {B} x beam {beam}")
    _check_beam(lib, name, beam)
    tensors = {"q": q, "kT": kT, "v": v, "k_scale": k_scale,
               "v_scale": v_scale}
    shapes = {"q": (BB, H, Dh), "kT": (B, H, Dh, S), "v": (B, H, S, Dh),
              "k_scale": (B, H, 1, S), "v_scale": (B, H, 1, S)}
    if bias is not None:
        tensors["bias"], shapes["bias"] = bias, (B, S)
    _check(lib, name, q, tensors, shapes, _INT8)
    out = torch.empty_like(q)
    _launch(lib, name, lib.stac_decode_cross_attention_int8, q.dtype,
            q.data_ptr(), kT.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, H, S, beam)
    return out
