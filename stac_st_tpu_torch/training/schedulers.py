"""Learning-rate schedules (port of ``stac_st_tpu/training/schedulers.py``).

``WarmCoolDecayLRSchedule``: linear warmup -> exponential decay
(``decay_factor ** (t / decay_every)``) -> linear cooldown to zero over the
last ``cooldown`` steps. ``value(step)`` is evaluated on the host in fp32,
as the reference evaluates it on the device; the optimizer step count it
takes is a host integer in the port.
"""

from __future__ import annotations

import numpy as np

__all__ = ["WarmCoolDecayLRSchedule", "NoamScheduler"]

_F = np.float32


class WarmCoolDecayLRSchedule:
    def __init__(self, lr: float, warmup: int, cooldown: int,
                 total_steps: int, decay_factor: float = 0.75,
                 decay_every: float = 100000):
        self.base_lr = float(lr)
        self.warmup = int(warmup)
        self.cooldown = int(cooldown)
        self.total_steps = int(total_steps)
        self.decay_factor = float(decay_factor)
        self.decay_every = float(decay_every)
        self.current_lr = 0.0

    def value(self, step) -> float:
        """LR at optimizer step ``step`` (1-based)."""
        step = _F(step)
        cool_start = self.total_steps - self.cooldown
        if step < self.warmup:
            lr = _F(self.base_lr) * step / _F(max(self.warmup, 1))
        elif step < cool_start:
            lr = _F(self.base_lr) * _F(self.decay_factor) ** (
                step / _F(self.decay_every))
        else:
            lr_at_cool = _F(self.base_lr * self.decay_factor ** (
                cool_start / self.decay_every))
            lr = lr_at_cool * max(_F(self.total_steps) - step, _F(0.0)) \
                / _F(max(self.cooldown, 1))
        return float(max(lr, _F(0.0)))

    def __call__(self, optimizer=None, num_updates: int = 0) -> float:
        """Reference-shaped stateful step; returns the new lr."""
        self.current_lr = self.value(num_updates)
        return self.current_lr

    def state_dict(self):
        return {"current_lr": self.current_lr}

    def load_state_dict(self, state):
        self.current_lr = state.get("current_lr", 0.0)


class NoamScheduler:
    """Inverse-sqrt warmup schedule."""

    def __init__(self, lr_initial: float, n_warmup_steps: int,
                 model_size=None):
        self.lr_initial = float(lr_initial)
        self.n_warmup_steps = int(n_warmup_steps)
        self.current_lr = 0.0

    def value(self, step) -> float:
        step = max(_F(step), _F(1.0))
        n = _F(self.n_warmup_steps)
        scale = n ** _F(0.5) * min(step ** _F(-0.5), step * n ** _F(-1.5))
        return float(_F(self.lr_initial) * scale)

    def __call__(self, optimizer=None, num_updates: int = 0) -> float:
        self.current_lr = self.value(num_updates)
        return self.current_lr

    def state_dict(self):
        return {"current_lr": self.current_lr}

    def load_state_dict(self, state):
        self.current_lr = state.get("current_lr", 0.0)
