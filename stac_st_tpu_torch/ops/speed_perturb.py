"""Speed perturbation on the host and on the device (port of
``stac_st_tpu/ops/speed_perturb.py``).

Resample the raw waveform to one of {90, 100, 110}% speed, one speed per
utterance (the reference's SpeechBrain ``SpeedPerturb``,
``transformer_multitask.yaml:295-297``).

* :class:`SpeedPerturb` runs in the loader on the host, before bucketing:
  a 90%-speed utterance grows past its bucket's width, and collation
  widens that batch to the 0.5 s grid.
* :class:`DeviceSpeedPerturb` leaves the audio alone on the host, which
  only draws a ``speed_idx`` per utterance; the train step resamples the
  batch on the device (:func:`device_resample`) into a buffer of the
  slowest speed's width, so a bucket keeps one shape.

Both draw the speed from a counter keyed by (epoch, row), not from a
stream, so the draw does not depend on decode order or worker count.

The device resample is one strided 1-D convolution whose ``up`` output
channels are the polyphase block of the host resampler
(``data/resample.py::_block_bank_c1``): ``torch.nn.functional.conv1d``,
as the JAX package leaves it to one XLA convolution (there is no TPU
kernel here). It runs in fp32 with TF32 off whatever the caller set, as
the JAX package runs it at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from contextlib import contextmanager
from math import gcd
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.resample import _block_bank_c1, fast_resample_poly
from ..utils.seeding import get_seed

__all__ = ["SpeedPerturb", "DeviceSpeedPerturb", "device_resample",
           "filter_bank"]


def _ratio(speed: int) -> Tuple[int, int]:
    """(up, down) of playing at ``speed``%: resampling by 100/speed."""
    g = gcd(100, int(speed))
    return 100 // g, int(speed) // g


class SpeedPerturb:
    """Host speed perturbation in the loader (applied in ``SpeechDataset``)."""

    def __init__(self, orig_freq: int = 16000, speeds: Optional[List[int]] = None,
                 **unused):
        self.orig_freq = int(orig_freq)
        self.speeds = [int(s) for s in (speeds or [90, 100, 110])]
        # the reference draws from torch's global RNG after the yaml's
        # manual_seed; here the seed is the one recorded by manual_seed
        self._seed = int(get_seed())
        self._rng = np.random.default_rng(self._seed)

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def speed_for(self, key) -> int:
        """Deterministic per-utterance speed, keyed by e.g. (epoch, row)."""
        r = np.random.default_rng((self._seed, *np.atleast_1d(key)))
        return self.speeds[int(r.integers(len(self.speeds)))]

    def perturbed_len(self, n: int, speed: int) -> int:
        """Output length of ``__call__`` on an ``n``-sample signal."""
        if speed == 100:
            return int(n)
        up, down = _ratio(speed)
        return -(-int(n) * up // down)

    def __call__(self, wav: np.ndarray, speed: Optional[int] = None):
        """wav: (L,) float array -> perturbed (L',) float32 array."""
        if speed is None:
            speed = self.speeds[int(self._rng.integers(len(self.speeds)))]
        if speed == 100:
            return np.asarray(wav, np.float32)
        return fast_resample_poly(np.asarray(wav, np.float32), 100,
                                  int(speed))


@contextmanager
def _cudnn_fp32():
    """cuDNN convolutions in full fp32 inside the block (TF32 off), and the
    caller's setting back after it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def filter_bank(up: int, down: int, device=None) -> torch.Tensor:
    """The polyphase block filter as a conv1d weight (up, 1, K + down),
    fp32, on ``device``."""
    F_host = _block_bank_c1(up, down)[0]
    return torch.from_numpy(np.ascontiguousarray(F_host.T))[:, None, :].to(
        device)


def device_resample(x: torch.Tensor, up: int, down: int, out_width: int,
                    bank: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched polyphase resample on ``x``'s device: x (B, W) ->
    (B, out_width), the host ``fast_resample_poly``'s filter and alignment
    (a cross-correlation of stride ``down``, as ``conv1d`` computes it).
    ``bank``: :func:`filter_bank` of (up, down) on x's device, if the
    caller keeps one. Computes in fp32 and returns x's dtype."""
    g = gcd(int(up), int(down))
    up, down = int(up) // g, int(down) // g
    B, W = x.shape
    if up == 1 and down == 1:
        if out_width == W:
            return x
        return F.pad(x, (0, out_width - W))

    _, K, _, s0 = _block_bank_c1(up, down)
    first = s0 - (K - 1)
    n_blocks = -(-out_width // up)
    pad_lo = max(0, -first)
    needed = (n_blocks - 1) * down + (K + down)
    pad_hi = max(0, needed - (W + min(first, 0) + pad_lo) - max(first, 0))
    xp = F.pad(x, (pad_lo, pad_hi))
    if first > 0:
        xp = xp[:, first:]
    if bank is None:
        bank = filter_bank(up, down, x.device)
    with _cudnn_fp32():
        out = F.conv1d(xp[:, None, :].float(), bank, stride=down)
    # (B, up, n_windows >= n_blocks) -> output t = block·up + phase
    y = out[:, :, :n_blocks].transpose(1, 2).reshape(B, -1)
    return y[:, :out_width].to(x.dtype)


class DeviceSpeedPerturb:
    """Speed perturbation applied on the device inside the train step.

    The host samples the per-utterance speed (keyed as
    :meth:`SpeedPerturb.speed_for`) and ships a ``speed_idx`` column;
    :meth:`apply` resamples the whole batch at every speed into a buffer
    of the slowest speed's width (:meth:`out_width`) and selects each row's
    variant. Relative lengths rescale by ``(100/speed) · W/W_out``.
    """

    device = True

    def __init__(self, orig_freq: int = 16000,
                 speeds: Optional[List[int]] = None, **unused):
        self.orig_freq = int(orig_freq)
        self.speeds = [int(s) for s in (speeds or [90, 100, 110])]
        self._seed = int(get_seed())
        self._rng = np.random.default_rng(self._seed)
        self._banks: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)

    def sample_index(self) -> int:
        return int(self._rng.integers(len(self.speeds)))

    def index_for(self, key) -> int:
        """Deterministic per-utterance speed index, keyed by (epoch, row)."""
        r = np.random.default_rng((self._seed, *np.atleast_1d(key)))
        return int(r.integers(len(self.speeds)))

    def out_width(self, in_width: int) -> int:
        """Static output width: the slowest speed's length."""
        widths = []
        for s in self.speeds:
            up, down = _ratio(s)
            widths.append(in_width * up // down + bool((in_width * up) % down))
        return max(widths)

    def _bank(self, up: int, down: int, device) -> torch.Tensor:
        """Each (up, down) filter bank is built on the host and moved to
        the device once."""
        key = (up, down, torch.device(device))
        if key not in self._banks:
            self._banks[key] = filter_bank(up, down, device)
        return self._banks[key]

    def apply(self, sig: torch.Tensor, lengths_rel: torch.Tensor,
              speed_idx: torch.Tensor):
        """sig (B, W) float, lengths_rel (B,) in [0, 1], speed_idx (B,) int
        -> (sig' (B, W_out), lengths_rel' (B,)), on sig's device."""
        B, W = sig.shape
        W_out = self.out_width(W)
        variants = []
        for s in self.speeds:
            up, down = _ratio(s)
            bank = None if up == down else self._bank(up, down, sig.device)
            variants.append(device_resample(sig, 100, s, W_out, bank))
        stacked = torch.stack(variants, dim=1)  # (B, S, W_out)
        idx = speed_idx.to(device=sig.device, dtype=torch.int64)
        # a gather of each row's variant: the values of JAX's one-hot
        # einsum exactly (1·x + 0·y + 0·z = x for finite inputs)
        out = stacked[torch.arange(B, device=sig.device), idx]
        ratios = torch.tensor([100.0 / s for s in self.speeds],
                              dtype=torch.float32, device=sig.device)
        new_rel = lengths_rel * ratios[idx] * (W / W_out)
        return out, torch.clamp(new_rel, max=1.0)
