"""SpecAugment (train-only augmentation), port of
``stac_st_tpu/ops/specaugment.py``.

Two parts: :func:`draw_spec_augment` draws the random parameters on the
host from a ``torch.Generator``; :func:`apply_spec_augment` applies them
on the features' device. The reference's semantics:

* time warp: ONE (centre c, target w) pair per batch, c ~ U[window,
  T − window), w = c + s with s ~ U[−window + 1, window]; ``feats[:, :c]``
  is resized to w frames and ``feats[:, c:]`` to T − w with
  align_corners=True interpolation, taps clamped to their own segment
  (bicubic: Keys' kernel, A = −0.75, as torch's ``interpolate``; other
  modes: linear);
* then ``n_freq_mask`` frequency and ``n_time_mask`` time masks per
  utterance, width ~ U[0, max_width), start ~ U[0, max(size − width, 1));
* masked cells take the mean of the whole (warped) batch, or 0 with
  ``replace_with_zero``.

Over ranks (``rows=(row0, n_rows)``): the draws are made for the global
batch's ``n_rows`` rows and the rank keeps its own; the fill is the
global batch's mean through ``reduce_sum``.

The random streams differ from JAX's; the tests feed both the same
parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

__all__ = ["SpecAugParams", "SpecAugment", "draw_spec_augment",
           "apply_spec_augment", "spec_augment", "warp_to"]

_CUBIC_A = -0.75


@dataclass
class SpecAugParams:
    warp: Optional[Tuple[int, int]]   # (c, w) or None
    freq_width: torch.Tensor          # (B, n_freq_mask) int64
    freq_start: torch.Tensor
    time_width: torch.Tensor          # (B, n_time_mask) int64
    time_start: torch.Tensor


def _cubic_weights(frac: torch.Tensor) -> torch.Tensor:
    a = _CUBIC_A

    def cc1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def cc2(x):  # 1 < |x| < 2
        return ((a * x - 5.0 * a) * x + 8.0 * a) * x - 4.0 * a

    x2 = 1.0 - frac
    return torch.stack([cc2(frac + 1.0), cc1(frac), cc1(x2), cc2(x2 + 1.0)],
                       dim=-1)


def _linear_weights(frac: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(frac)
    return torch.stack([zero, 1.0 - frac, frac, zero], dim=-1)


def warp_to(feats: torch.Tensor, c: int, w: int, mode: str) -> torch.Tensor:
    """Resize [:c] -> w frames and [c:] -> T − w (the deterministic core
    of the warp). feats (B, T, D)."""
    T = feats.shape[1]
    dev = feats.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.arange(T, **f32)
    c_f, w_f = torch.tensor(float(c), **f32), torch.tensor(float(w), **f32)
    T_f = torch.tensor(float(T), **f32)
    in_left = t < w_f

    def seg_scale(out_len, in_len):
        # align_corners=True; an output of one frame reads source 0
        return torch.where(out_len > 1.0, (in_len - 1.0) / torch.clamp(
            out_len - 1.0, min=1.0), torch.zeros((), **f32))

    src = torch.where(in_left, t * seg_scale(w_f, c_f),
                      (t - w_f) * seg_scale(T_f - w_f, T_f - c_f))
    base = torch.floor(src)
    frac = src - base
    taps = base[:, None] + torch.arange(-1.0, 3.0, **f32)  # (T, 4)
    hi = torch.where(in_left, c_f - 1.0, T_f - c_f - 1.0)[:, None]
    off = torch.where(in_left, 0.0, c_f)[:, None]
    idx = (torch.minimum(torch.clamp(taps, min=0.0), hi) + off).long()
    wts = _cubic_weights(frac) if mode == "bicubic" else _linear_weights(frac)
    gathered = feats.to(torch.float32)[:, idx, :]  # (B, T, 4, D)
    out = (gathered * wts[None, :, :, None]).sum(2)
    return out.to(feats.dtype)


def draw_spec_augment(shape, generator: torch.Generator,
                      time_warp: bool = True, time_warp_window: int = 5,
                      time_warp_mode: str = "bicubic", freq_mask: bool = True,
                      n_freq_mask: int = 2, freq_mask_width: int = 30,
                      time_mask: bool = True, n_time_mask: int = 2,
                      time_mask_width: int = 40,
                      replace_with_zero: bool = False) -> SpecAugParams:
    """Draw the parameters for features of ``shape`` (B, T, D) on the host."""
    B, T, D = shape

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (), generator=generator))

    warp = None
    if time_warp and T - time_warp_window > time_warp_window:
        c = randint(time_warp_window, T - time_warp_window)
        warp = (c, c + randint(-time_warp_window, time_warp_window) + 1)

    def masks(on, n, max_width, size):
        width = torch.zeros((B, n if on else 0), dtype=torch.int64)
        start = torch.zeros_like(width)
        for b in range(B):
            for i in range(width.shape[1]):
                width[b, i] = randint(0, max_width)
                start[b, i] = randint(0, max(size - int(width[b, i]), 1))
        return width, start

    fw, fs = masks(freq_mask, n_freq_mask, freq_mask_width, D)
    tw, ts = masks(time_mask, n_time_mask, time_mask_width, T)
    return SpecAugParams(warp, fw, fs, tw, ts)


def _span_mask(width, start, size: int, device) -> torch.Tensor:
    """(B, n) spans -> (B, size) bool, True inside any span."""
    idx = torch.arange(size, device=device)[None, None, :]
    w, s = width.to(device)[..., None], start.to(device)[..., None]
    return ((idx >= s) & (idx < s + w)).any(1)


def apply_spec_augment(feats: torch.Tensor, params: SpecAugParams,
                       time_warp_mode: str = "bicubic",
                       replace_with_zero: bool = False, reduce_sum=None,
                       n_rows: Optional[int] = None,
                       **unused) -> torch.Tensor:
    """Warp, then fill every masked cell with the batch mean (or 0);
    with ``reduce_sum`` the mean of the global batch of ``n_rows``."""
    if params.warp is not None:
        feats = warp_to(feats, *params.warp, time_warp_mode)
    B, T, D = feats.shape
    if replace_with_zero:
        fill = torch.zeros((), dtype=feats.dtype, device=feats.device)
    elif reduce_sum is not None:
        fill = reduce_sum(feats.sum()[None])[0] / float(n_rows * T * D)
    else:
        fill = feats.mean()
    masked = (_span_mask(params.time_width, params.time_start, T,
                         feats.device)[:, :, None]
              | _span_mask(params.freq_width, params.freq_start, D,
                           feats.device)[:, None, :])
    return torch.where(masked, fill, feats)


def spec_augment(feats: torch.Tensor, generator: torch.Generator,
                 rows: Optional[Tuple[int, int]] = None, reduce_sum=None,
                 **opts) -> torch.Tensor:
    """Draw on the host, apply on the features' device. ``rows``:
    (first global row, global row count) of a rank's rows."""
    if rows is None:
        return apply_spec_augment(
            feats, draw_spec_augment(tuple(feats.shape), generator, **opts),
            **opts)
    row0, n_rows = rows
    B = feats.shape[0]
    p = draw_spec_augment((n_rows,) + tuple(feats.shape[1:]), generator,
                          **opts)
    mine = slice(row0, row0 + B)
    p = SpecAugParams(p.warp, p.freq_width[mine], p.freq_start[mine],
                      p.time_width[mine], p.time_start[mine])
    return apply_spec_augment(feats, p, reduce_sum=reduce_sum,
                              n_rows=n_rows, **opts)


class SpecAugment:
    """The hparams-facing option surface (reference yaml defaults)."""

    def __init__(self, time_warp: bool = True, time_warp_window: int = 5,
                 time_warp_mode: str = "bicubic", freq_mask: bool = True,
                 n_freq_mask: int = 2, time_mask: bool = True,
                 n_time_mask: int = 2, replace_with_zero: bool = False,
                 freq_mask_width: int = 30, time_mask_width: int = 40,
                 **unused):
        self.opts = dict(
            time_warp=bool(time_warp), time_warp_window=int(time_warp_window),
            time_warp_mode=str(time_warp_mode), freq_mask=bool(freq_mask),
            n_freq_mask=int(n_freq_mask),
            freq_mask_width=int(freq_mask_width), time_mask=bool(time_mask),
            n_time_mask=int(n_time_mask),
            time_mask_width=int(time_mask_width),
            replace_with_zero=bool(replace_with_zero))

    def __call__(self, feats: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        return spec_augment(feats, generator, **self.opts)
