"""Default device, dtype helpers and the TF32 switches.

Every entry point of the port takes a ``device`` argument that defaults to
``"cuda"``. The CPU is used only when a caller asks for it (the tests do);
asking for CUDA on a machine without it raises instead of silently running
on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "set_tf32", "model_dtype"]

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the default (``cuda``). Raises when CUDA is asked for
    and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run on the CPU"
        )
    return dev


def set_tf32(enabled: bool) -> None:
    """Set both TF32 switches explicitly.

    fp32 parity with the JAX reference needs both off: cuBLAS matmuls
    already default to full fp32, but cuDNN convolutions default to TF32
    (about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)


def model_dtype(bf16: bool) -> torch.dtype:
    """Parameter/activation dtype of the serving model."""
    return torch.bfloat16 if bf16 else torch.float32
