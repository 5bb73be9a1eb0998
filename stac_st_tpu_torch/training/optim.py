"""Optimizer factories (port of ``stac_st_tpu/training/optim.py``).

The hparams name an optimizer (``AdamW(lr=...)``); the result is an
:class:`OptimizerFactory` that :func:`~.step.make_optimizer` turns into
the reference's update chain (accumulation, nonfinite skip, clipping,
Adam(W), the learning-rate schedule).
"""

from __future__ import annotations

__all__ = ["AdamW", "Adam", "OptimizerFactory"]


class OptimizerFactory:
    def __init__(self, kind: str, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        if kind not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.lr = float(lr)
        self.betas = tuple(float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)

    def __call__(self, params=None):  # reference shape: AdamW(parameters)
        return self


def AdamW(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.01) -> OptimizerFactory:
    return OptimizerFactory("adamw", lr, betas, eps, weight_decay)


def Adam(lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
         weight_decay: float = 0.0) -> OptimizerFactory:
    return OptimizerFactory("adam", lr, betas, eps, weight_decay)
