"""Seeding helpers (port of ``stac_st_tpu/utils/seeding.py``).

The reference YAML calls ``torch.manual_seed(seed)`` at load time. Here
that records the seed, and :func:`root_generator` gives a fresh CPU
``torch.Generator`` seeded from it in place of the JAX package's root
PRNG key. The port draws its randomness from explicit generators, never
from torch's global one.
"""

from __future__ import annotations

import torch

__all__ = ["manual_seed", "get_seed", "root_generator"]

_GLOBAL_SEED = 0


def manual_seed(seed: int) -> int:
    global _GLOBAL_SEED
    _GLOBAL_SEED = int(seed)
    return _GLOBAL_SEED


def get_seed() -> int:
    return _GLOBAL_SEED


def root_generator() -> torch.Generator:
    return torch.Generator().manual_seed(_GLOBAL_SEED)
