"""PyTorch/CUDA port of STAC-ST for NVIDIA Hopper: serving, and training
from a manifest on disk (data pipeline, tokenizer, train step).

A second package beside :mod:`stac_st_tpu` (the JAX reference). Module
paths mirror the JAX package so a reader finds each counterpart; the code
inside is PyTorch idiom. The port imports nothing of JAX and nothing of
``stac_st_tpu``: what it needs from there it keeps as its own copy.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

Attention runs through hand-written CUDA kernels (``csrc/*.cu``, bound in
``ops/kernels``); on CPU tensors the same wrappers take their plain
PyTorch versions.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
