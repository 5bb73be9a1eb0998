"""Dropout with explicit generators.

A training step draws all its randomness from one integer seed through a
:class:`StepRandom`: a CPU generator for what is drawn on the host (the
attention kernels' int32 seeds, SpecAugment's parameters) and a generator
on the step's device for dropout masks, so no draw synchronises with the
card and torch's global generator is never used.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["StepRandom", "dropout"]


class StepRandom:
    def __init__(self, seed: int, device="cpu"):
        dev = torch.device(device)
        self.host = torch.Generator().manual_seed(int(seed))
        self.on_device = self.host if dev.type == "cpu" else \
            torch.Generator(device=dev).manual_seed(int(seed))

    def kernel_seed(self) -> int:
        """A fresh 32-bit seed for one in-kernel dropout call."""
        return int(torch.randint(0, 2 ** 32, (), generator=self.host,
                                 dtype=torch.int64))

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.on_device, device=device)

    def get_state(self):
        """Both generators' states, for :meth:`set_state` to replay the
        draws that follow (a recomputed layer's dropout masks and kernel
        seeds)."""
        return self.host.get_state(), self.on_device.get_state()

    def set_state(self, state) -> None:
        self.host.set_state(state[0])
        self.on_device.set_state(state[1])


def dropout(x: torch.Tensor, p: float,
            rng: Optional[StepRandom]) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 − p, scale by 1/(1 − p)."""
    if p <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout with p > 0 needs a StepRandom")
    keep = rng.uniform(x.shape, x.device) >= p
    return torch.where(keep, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))
