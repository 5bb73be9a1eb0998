"""Flash attention for training: CUDA kernels, plain versions, autograd.

Port of ``stac_st_tpu/ops/pallas/train_attention.py``. Three kernels of
``csrc/train_attention.cu`` (``KERNELS`` names the TPU kernel each
replaces):

* ``flash_attention_train_fwd`` <- ``_fwd_kernel`` (train_attention.py:294):
  O = softmax(scale·QKᵀ + bias)·V with in-kernel dropout on the weights,
  plus the per-row logsumexp L. ``flash_attention`` shares its kernels;
* ``flash_attention_train_dq`` <- ``_dq_kernel`` (:344);
* ``flash_attention_train_dkv`` <- ``_dkv_kernel`` (:356).

Each has two CUDA kernels, chosen by :func:`flash_variant` (the only copy
of the rule) from dtype and head dim alone: ``wgmma`` (bf16 and fp16 at
Dh 64, every configuration of the repository: TMA-fed tiles, every
product on the tensor cores, P and dS rounded to the input type before
the products that take them) and ``simt`` (fp32 and other head dims, on
the fp32 CUDA cores: a fp32 train step is held to the CPU at 1e-5, which
tensor cores in TF32 or bf16 cannot meet).

:func:`flash_attention_train` ties them into a ``torch.autograd.Function``:
the backward recomputes P from Q, K and L (nothing of size T² is saved),
with δ = rowsum(dO∘O) a plain torch reduction, as the reference computes it
outside its kernels.

Layouts are the reference's public ones: q/k/v (B, T, H, Dh) contiguous,
bias (B, Tk) fp32 or None, L and δ (B, H, Tq) fp32. Dh ≤ 128 and a
multiple of 8; any Tq, Tk; fp32, bf16 or fp16 with fp32 accumulation.

Dropout is the reference's counter-path mask, bit for bit: keep (i, j) iff
a murmur3-fmix32 hash of (seed, b·H + h, tile coordinates) is at least
``min(int(p·2³²), 2³²−1)``, kept weights scaled by 1/(1−p). The tile
coordinates are those of the reference's logical tiling (:func:`tile_rows`),
whatever tiles the CUDA kernel itself uses; so the plain versions equal the
JAX kernel run in interpret mode, and the CUDA kernels equal the plain
versions. Given the same seed, forward and backward see the same mask.
``b`` is the row's index in the global batch: a data-parallel rank holding
rows ``row0 ..`` of it passes ``row0``, so its masks are those rows' masks
in a step over the whole batch on one device.

A wrapper given CPU tensors runs its ``*_ref`` plain version. Given CUDA
tensors it checks dtype, shape and contiguity, launches on the current
stream, raises if the launch failed, and counts the launch under
``<name>`` and ``<name>/<variant>``, the kernel it asked the library to
launch; there is no fallback from a CUDA tensor to the plain version,
nor from one kernel to the other.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import count_launch, load_library

__all__ = [
    "flash_attention_train", "flash_attention_train_fwd",
    "flash_attention_train_fwd_ref", "flash_attention_train_dq",
    "flash_attention_train_dq_ref", "flash_attention_train_dkv",
    "flash_attention_train_dkv_ref", "dropout_keep", "tile_rows",
    "flash_variant", "KERNELS",
]

NEG_INF = -1e9
TILE_CAP = 512  # the reference's single-tile cap (train_attention.py:237)
_LIB = "train_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_M32 = 0xFFFFFFFF

_SRC = "stac_st_tpu_torch/csrc/train_attention.cu"
# name -> (TPU kernel it replaces, source of the Hopper kernel)
KERNELS = {
    "flash_attention_train_fwd": (
        "stac_st_tpu/ops/pallas/train_attention.py:294", _SRC),
    "flash_attention_train_dq": (
        "stac_st_tpu/ops/pallas/train_attention.py:344", _SRC),
    "flash_attention_train_dkv": (
        "stac_st_tpu/ops/pallas/train_attention.py:356", _SRC),
}


# ------------------------------------------------------------ dropout mask
def tile_rows(T: int) -> int:
    """Rows per tile of the reference's logical tiling of an axis of T:
    one tile of ceil8(T) rows when that is <= 512, else 128-row tiles."""
    t8 = -(-T // 8) * 8
    return t8 if t8 <= TILE_CAP else 128


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def tile_hash(seed: int, bh: torch.Tensor, qt: torch.Tensor,
              kt: torch.Tensor, row: torch.Tensor,
              col: torch.Tensor) -> torch.Tensor:
    """The reference's counter hash as uint32 values in int64, broadcast
    over its arguments (``_dropout_mask``, train_attention.py:67-91)."""
    s = _mul32(torch.tensor(seed & _M32, dtype=torch.int64), 0x9E3779B1)
    h = (s ^ _mul32(bh + 1, 0x85EBCA6B) ^ _mul32(qt + 1, 0xC2B2AE35)
         ^ _mul32(kt + 1, 0x27D4EB2F))
    x = (h + _mul32(row, 0x01000193) + _mul32(col, 0x0000F1A7)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _threshold(p_drop: float) -> int:
    return min(int(p_drop * 2.0 ** 32), 2 ** 32 - 1)


def _inv_keep(p_drop: float) -> float:
    # fp32 1/(1-p), as the reference divides its fp32 keep mask
    return float(np.float32(1.0) / np.float32(1.0 - p_drop))


def dropout_keep(seed: int, B: int, H: int, Tq: int, Tk: int,
                 p_drop: float, device=None, row0: int = 0) -> torch.Tensor:
    """(B, H, Tq, Tk) fp32: keep/(1−p) for every (query, key) of every
    head, the rows being rows ``row0 ..`` of the global batch."""
    qt_rows, kt_rows = tile_rows(Tq), tile_rows(Tk)
    i = torch.arange(Tq, device=device, dtype=torch.int64)
    j = torch.arange(Tk, device=device, dtype=torch.int64)
    bh = torch.arange(row0 * H, (row0 + B) * H, device=device,
                      dtype=torch.int64)
    x = tile_hash(seed, bh[:, None, None], (i // qt_rows)[None, :, None],
                  (j // kt_rows)[None, None, :], (i % qt_rows)[None, :, None],
                  (j % kt_rows)[None, None, :])
    keep = (x >= _threshold(p_drop)).to(torch.float32)
    return (keep / np.float32(1.0 - p_drop)).reshape(B, H, Tq, Tk)


# ------------------------------------------------------------ plain versions
def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, Dh) -> (B, H, T, Dh) fp32."""
    return x.float().permute(0, 2, 1, 3)


def _bias4(bias: Optional[torch.Tensor]):
    return 0.0 if bias is None else bias.float()[:, None, None, :]


def flash_attention_train_fwd_ref(q, k, v, bias, seed: int, p_drop: float,
                                  row0: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O (B, Tq, H, Dh) in q's dtype and L (B, H, Tq) fp32: the max is
    floored at −1e9 and dropout hits the weights after the normaliser is
    summed, as in the reference kernel."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    s = torch.matmul(_heads(q) * scale, _heads(k).transpose(-1, -2))
    s = s + _bias4(bias)
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if p_drop > 0.0:
        p = p * dropout_keep(seed, B, H, Tq, Tk, p_drop, q.device, row0)
    den = torch.clamp(l, min=1e-30)
    out = torch.matmul(p, _heads(v)) / den
    lse = torch.where(l > 0, m + torch.log(den), NEG_INF)[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse.contiguous()


def _bwd_parts(q, k, v, bias, seed, p_drop, dout, lse, delta, row0):
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    scale = 1.0 / math.sqrt(Dh)
    qf, kf, vf, dof = _heads(q), _heads(k), _heads(v), _heads(dout)
    s = scale * torch.matmul(qf, kf.transpose(-1, -2)) + _bias4(bias)
    p = torch.exp(s - lse[..., None])
    dpd = torch.matmul(dof, vf.transpose(-1, -2))
    pm = p
    if p_drop > 0.0:
        keep = dropout_keep(seed, B, H, Tq, Tk, p_drop, q.device, row0)
        dpd = dpd * keep
        pm = p * keep
    ds = p * (dpd - delta[..., None])
    return scale, qf, kf, dof, pm, ds


def flash_attention_train_dq_ref(q, k, v, bias, seed: int, p_drop: float,
                                 dout, lse, delta, row0: int = 0
                                 ) -> torch.Tensor:
    """dQ (B, Tq, H, Dh) in dout's dtype."""
    scale, _, kf, _, _, ds = _bwd_parts(q, k, v, bias, seed, p_drop, dout,
                                        lse, delta, row0)
    dq = torch.matmul(ds, kf) * scale
    return dq.permute(0, 2, 1, 3).to(dout.dtype)


def flash_attention_train_dkv_ref(q, k, v, bias, seed: int, p_drop: float,
                                  dout, lse, delta, row0: int = 0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV (B, Tk, H, Dh) in k's dtype."""
    scale, qf, _, dof, pm, ds = _bwd_parts(q, k, v, bias, seed, p_drop,
                                           dout, lse, delta, row0)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(pm.transpose(-1, -2), dof)
    return (dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(k.dtype))


# ------------------------------------------------------------------ kernels
def lib():
    """The loaded kernel library, argument types bound."""
    lb = load_library(_LIB)
    if not getattr(lb, "_stac_bound", False):
        # scale, seed, thresh, inv_keep, tiles, on, bh0, dtype, stream
        drop = [_F, _U, _U, _F, _I, _I, _I, _U, _I, _P]
        dims = [_I, _I, _I, _I, _I]                 # B, H, Tq, Tk, Dh
        lb.stac_flash_fwd.argtypes = [_P] * 6 + dims + drop + [_I]
        lb.stac_flash_dq.argtypes = [_P] * 8 + dims + drop + [_I]
        lb.stac_flash_dkv.argtypes = [_P] * 9 + dims + drop + [_I]
        for fn in (lb.stac_flash_fwd, lb.stac_flash_dq, lb.stac_flash_dkv,
                   lb.stac_flash_max_head_dim):
            fn.restype = _I
        lb.stac_flash_max_head_dim.argtypes = []
        lb.stac_flash_error_string.argtypes = [_I]
        lb.stac_flash_error_string.restype = ctypes.c_char_p
        lb._stac_bound = True
    return lb


def on_cpu(*tensors) -> bool:
    """True for CPU tensors (the plain version runs), False for tensors on
    one CUDA device (the kernel runs); raises on anything else."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"tensors must all be on one CUDA device or all on "
                         f"the CPU, got {sorted(map(str, devs))}")
    return False


def check(name: str, q, k, v, bias, extra=()) -> Tuple[int, ...]:
    """Validate the inputs of a flash kernel; returns (B, H, Tq, Tk, Dh)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q/k/v must be (B, T, H, Dh)")
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if Dh % 8 or not 8 <= Dh <= 128:
        raise ValueError(f"{name}: head dim {Dh} must be a multiple of 8 "
                         f"in [8, 128]")
    tensors = [("k", k, (B, Tk, H, Dh), q.dtype),
               ("v", v, (B, Tk, H, Dh), q.dtype), *extra]
    if bias is not None:
        tensors.append(("bias", bias, (B, Tk), torch.float32))
    for label, t, shape, dtype in [("q", q, (B, Tq, H, Dh), q.dtype),
                                   *tensors]:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if Tq == 0 or Tk == 0 or B * H == 0:
        raise ValueError(f"{name}: empty input")
    return B, H, Tq, Tk, Dh


def raise_on(lb, name: str, rc: int) -> None:
    if rc != 0:
        msg = lb.stac_flash_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed ({rc}: {msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def drop_args(scale: float, seed: int, p_drop: float, Tq: int, Tk: int,
              dtype: torch.dtype, bh0: int = 0):
    on = p_drop > 0.0
    return (scale, seed & _M32, _threshold(p_drop) if on else 0,
            _inv_keep(p_drop) if on else 1.0, tile_rows(Tq), tile_rows(Tk),
            int(on), bh0 & _M32, _DTYPES[dtype], stream())


def flash_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves (dtype, head dim) on the card, one fixed rule
    for the forward, dQ and dK/dV: ``wgmma`` (the tensor cores) for bf16
    and fp16 at Dh 64, ``simt`` (the fp32 CUDA cores) for fp32, which is
    held to the CPU at 1e-5, and for every other head dim."""
    tc = dtype in (torch.bfloat16, torch.float16) and head_dim == 64
    return "wgmma" if tc else "simt"


def _launch(name: str, fn, dtype: torch.dtype, head_dim: int, *args):
    """Call library entry point ``fn`` with ``args`` and the variant of
    :func:`flash_variant`; raise if it failed, else count the launch."""
    variant = flash_variant(dtype, head_dim)
    raise_on(lib(), name, fn(*args, int(variant == "wgmma")))
    count_launch(name)
    count_launch(f"{name}/{variant}")


def launch_fwd(name: str, q, k, v, bias, with_lse: bool, scale: float,
               seed: int, p_drop: float, row0: int = 0):
    """Launch the forward on CUDA tensors; returns (O, L or None)."""
    B, H, Tq, Tk, Dh = check(name, q, k, v, bias)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch(name, lib().stac_flash_fwd, q.dtype, Dh,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, Tq, Tk, Dh,
            *drop_args(scale, seed, p_drop, Tq, Tk, q.dtype, row0 * H))
    return out, lse


def flash_attention_train_fwd(q, k, v, bias, seed: int, p_drop: float,
                              row0: int = 0):
    """See :func:`flash_attention_train_fwd_ref`."""
    if on_cpu(q, k, v, bias):
        return flash_attention_train_fwd_ref(q, k, v, bias, seed, p_drop,
                                             row0)
    return launch_fwd("flash_attention_train_fwd", q, k, v, bias,
                      with_lse=True, scale=1.0 / math.sqrt(q.shape[-1]),
                      seed=seed, p_drop=p_drop, row0=row0)


def _bwd_extra(q, dout, lse, delta):
    B, Tq, H, Dh = q.shape
    return [("dout", dout, (B, Tq, H, Dh), q.dtype),
            ("lse", lse, (B, H, Tq), torch.float32),
            ("delta", delta, (B, H, Tq), torch.float32)]


def flash_attention_train_dq(q, k, v, bias, seed: int, p_drop: float,
                             dout, lse, delta, row0: int = 0):
    """See :func:`flash_attention_train_dq_ref`."""
    if on_cpu(q, k, v, bias, dout, lse, delta):
        return flash_attention_train_dq_ref(q, k, v, bias, seed, p_drop,
                                            dout, lse, delta, row0)
    return launch_dq(q, k, v, bias, seed, p_drop, dout, lse, delta, row0)


def launch_dq(q, k, v, bias, seed: int, p_drop: float, dout, lse, delta,
              row0: int = 0):
    """Launch dQ on CUDA tensors."""
    name = "flash_attention_train_dq"
    B, H, Tq, Tk, Dh = check(name, q, k, v, bias,
                             _bwd_extra(q, dout, lse, delta))
    dq = torch.empty_like(q)
    _launch(name, lib().stac_flash_dq, q.dtype, Dh,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Tq, Tk, Dh,
            *drop_args(1.0 / math.sqrt(Dh), seed, p_drop, Tq, Tk, q.dtype,
                       row0 * H))
    return dq


def flash_attention_train_dkv(q, k, v, bias, seed: int, p_drop: float,
                              dout, lse, delta, row0: int = 0):
    """See :func:`flash_attention_train_dkv_ref`."""
    if on_cpu(q, k, v, bias, dout, lse, delta):
        return flash_attention_train_dkv_ref(q, k, v, bias, seed, p_drop,
                                             dout, lse, delta, row0)
    return launch_dkv(q, k, v, bias, seed, p_drop, dout, lse, delta, row0)


def launch_dkv(q, k, v, bias, seed: int, p_drop: float, dout, lse, delta,
               row0: int = 0):
    """Launch dK/dV on CUDA tensors."""
    name = "flash_attention_train_dkv"
    B, H, Tq, Tk, Dh = check(name, q, k, v, bias,
                             _bwd_extra(q, dout, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(name, lib().stac_flash_dkv, q.dtype, Dh,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Tq, Tk, Dh,
            *drop_args(1.0 / math.sqrt(Dh), seed, p_drop, Tq, Tk, q.dtype,
                       row0 * H))
    return dk, dv


def row_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) in fp32, (B, Tq, H, Dh) -> (B, H, Tq)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


class _FlashAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed: int, p_drop: float, row0: int):
        out, lse = flash_attention_train_fwd(q, k, v, bias, seed, p_drop,
                                             row0)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.seed, ctx.p_drop, ctx.row0 = seed, p_drop, row0
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        delta = row_delta(g, out)
        args = (q, k, v, bias, ctx.seed, ctx.p_drop, g, lse, delta, ctx.row0)
        dq = flash_attention_train_dq(*args)
        dk, dv = flash_attention_train_dkv(*args)
        # the key-padding bias derives from lengths: no gradient flows to it
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, bias: Optional[torch.Tensor] = None,
                          seed: int = 0, p_drop: float = 0.0,
                          row0: int = 0) -> torch.Tensor:
    """Differentiable flash attention with in-kernel dropout.

    q (B, Tq, H, Dh), k/v (B, Tk, H, Dh), bias (B, Tk) additive key-padding
    bias or None, ``seed`` a host int (its low 32 bits are used; ignored
    when ``p_drop`` is 0), ``row0`` the global batch row of q's first row
    (the dropout mask's key). Returns (B, Tq, H, Dh) in q's dtype."""
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    return _FlashAttentionTrain.apply(q.contiguous(), k.contiguous(),
                                      v.contiguous(), bias, int(seed),
                                      float(p_drop), int(row0))
