"""Weight-only int8 for the decode path (serving).

Port of ``stac_st_tpu/utils/quantize.py``. Every decode step reads all
decoder weights again; in int8 that stream is half of bf16's. The same
leaves as the reference's ``quantize_decode_weights`` are rewritten:

* decoder self-attention q/k/v (the one ``in_proj``) and out-projection;
* decoder cross-attention q and out-projection, not k/v: those run once
  per utterance in ``project_kv_decode`` and stay float
  (``CrossInProjInt8``);
* decoder FFN fc1/fc2;
* the ``seq_lin`` head.

Encoder, embedding, front end and CTC head stay float. Quantization is
symmetric int8 with one fp32 scale per output row of the PyTorch weight
(the reference's output column of its (in, out) kernel): max|W[j]|/127,
at least 1e-8/127, round half to even, clipped to ±127. Quantizing the
(3·d, d) ``in_proj`` row by row is the reference's concatenation of its
q/k/v per-column scales.

A quantized module computes what the reference's ``dq_dense_params``
does: y = (x @ W_int8 in x's dtype, summed in fp32) · scale + bias, cast
to x's dtype. Here the product is ``torch.matmul`` in x's dtype and the
scale is applied to its result in fp32 (the CPU in fp32 is the exact
form). The scales stay fp32 whatever ``Module.to`` later asks, and the
engine quantizes after its bf16 cast, as the reference does.

Quantized modules serve only the KV-cached decode path: the teacher-forced
forward, the full-prefix ``decode`` oracle and training raise on them
(``MultiHeadAttention.forward``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["Int8Linear", "CrossInProjInt8", "quantize_dense_params",
           "quantize_decode_weights"]


def quantize_dense_params(weight: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight (out, in) -> int8 weight (out, in) and fp32 scale (out,):
    the value in its own dtype, cast to fp32, divided (not multiplied by a
    reciprocal) by its row's scale."""
    w = weight.detach().float()
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-8) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return wq.to(torch.int8), scale


class Int8Linear(nn.Module):
    """A ``nn.Linear`` with an int8 weight and one fp32 scale per output
    row (decode only)."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.out_features, self.in_features = weight.shape
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale.float())
        self.register_buffer("bias", None if bias is None
                             else bias.detach().clone())

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        wq, scale = quantize_dense_params(lin.weight)
        return cls(wq, scale, lin.bias)

    def _apply(self, fn, recurse=True):
        # Module.to casts every floating buffer; the scales stay fp32
        scale = self.scale
        super()._apply(fn, recurse)
        self.scale = scale.to(self.weight.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight.to(x.dtype).t()).float() * self.scale
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


class CrossInProjInt8(nn.Module):
    """The cross-attention ``in_proj`` with its query rows in int8 (``q``)
    and its key/value rows float (``kv``, (2·d, d)): ``part(x, 0)`` is the
    query projection of a decode step, parts 1 and 2 the encode-phase
    key and value projections."""

    def __init__(self, in_proj: nn.Linear):
        super().__init__()
        d = in_proj.in_features
        self.d_model = d
        q = nn.Linear(d, d).to(in_proj.weight)
        kv = nn.Linear(d, 2 * d).to(in_proj.weight)
        with torch.no_grad():
            q.weight.copy_(in_proj.weight[:d])
            q.bias.copy_(in_proj.bias[:d])
            kv.weight.copy_(in_proj.weight[d:])
            kv.bias.copy_(in_proj.bias[d:])
        self.q = Int8Linear.from_linear(q)
        self.kv = kv

    def part(self, x: torch.Tensor, part: int) -> torch.Tensor:
        if part == 0:
            return self.q(x)
        d = self.d_model
        sl = slice((part - 1) * d, part * d)
        return F.linear(x, self.kv.weight[sl], self.kv.bias[sl])


@torch.no_grad()
def quantize_decode_weights(transformer: nn.Module,
                            seq_lin: Optional[nn.Module] = None) -> None:
    """Quantize, in place, the decode-path weights of a
    ``TransformerMultiTask`` (and the ``seq_lin`` head): the leaves of the
    reference's ``quantize_decode_weights``. Quantize after any dtype
    cast: the scales are taken from the weights as they stand."""
    for layer in transformer.decoder.layers:
        sa, ca, ffn = layer.self_attn, layer.cross_attn, layer.ffn
        sa.in_proj = Int8Linear.from_linear(sa.in_proj)
        sa.out_proj = Int8Linear.from_linear(sa.out_proj)
        ca.in_proj = CrossInProjInt8(ca.in_proj)
        ca.out_proj = Int8Linear.from_linear(ca.out_proj)
        ffn.fc1 = Int8Linear.from_linear(ffn.fc1)
        ffn.fc2 = Int8Linear.from_linear(ffn.fc2)
    if seq_lin is not None:
        seq_lin.linear = Int8Linear.from_linear(seq_lin.linear)
