"""Flash attention for deterministic inference: CUDA kernel, plain version.

Port of ``stac_st_tpu/ops/pallas/attention.py`` (``flash_attention``,
kernel ``_attn_kernel`` :35, call :69): softmax(QKᵀ/√Dh + bias)·V with an
additive key-padding bias (B, Tk) fp32 or None. As in the reference, q is
scaled in its own dtype before the kernel (attention.py:84) and the
running max starts at −1e9. The kernels are the training forward's of
``csrc/train_attention.cu`` without L and without dropout, chosen by
dtype and head dim alone (:func:`.train_attention.flash_variant`): bf16 and
fp16 at Dh 64 run ``fwd_tc_kernel`` (``wgmma``: one warpgroup per 64
query rows, K/V tiles by TMA, both products on the tensor cores, P
rounded to the input type before P·V); fp32 and other head dims run
``fwd_kernel`` (``simt``) on the fp32 CUDA cores, because the fp32 path is
held to the CPU at 1e-5, which TF32 or bf16 tensor cores cannot meet. See
:mod:`.train_attention` for the layout and the bound.

The port runs it on the teacher-forced forward with training off
(``make_eval_forward``): encoder self-attention and decoder
cross-attention. ``encode`` (serving) keeps its plain path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .train_attention import launch_fwd, on_cpu

__all__ = ["flash_attention", "flash_attention_ref", "KERNELS"]

NEG_INF = -1e9

KERNELS = {
    "flash_attention": ("stac_st_tpu/ops/pallas/attention.py:69",
                        "stac_st_tpu_torch/csrc/train_attention.cu"),
}


def _scaled(q: torch.Tensor) -> torch.Tensor:
    return q * (1.0 / math.sqrt(q.shape[-1]))  # in q's dtype


def flash_attention_ref(q, k, v, bias: Optional[torch.Tensor] = None):
    """q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) -> (B, Tq, H, Dh) in q's dtype."""
    qs = _scaled(q).float().permute(0, 2, 1, 3)
    s = torch.matmul(qs, k.float().permute(0, 2, 3, 1))
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    m = torch.clamp(s.amax(-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    out = torch.matmul(p, v.float().permute(0, 2, 1, 3))
    out = out / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None):
    """See :func:`flash_attention_ref`."""
    if on_cpu(q, k, v, bias):
        return flash_attention_ref(q, k, v, bias)
    out, _ = launch_fwd("flash_attention", _scaled(q).contiguous(), k, v,
                        bias, with_lse=False, scale=1.0, seed=0, p_drop=0.0)
    return out
