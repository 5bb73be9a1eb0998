"""PyTorch/CUDA port of the STAC-ST serving path for NVIDIA Hopper.

A second package beside :mod:`stac_st_tpu` (the JAX reference). Module
paths mirror the JAX package so a reader finds each counterpart; the code
inside is PyTorch idiom. The port imports nothing of JAX and nothing of
``stac_st_tpu``: what it needs from there it keeps as its own copy.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for CUDA where there is none raises.

The decode-attention hot loop runs through hand-written CUDA kernels
(``csrc/decode_attention.cu``, bound in ``ops/kernels``); on CPU tensors
the same wrappers take their plain PyTorch versions.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
