"""Step timer for the training loop (port of
``stac_st_tpu/utils/profiling.py``'s ``StepTimer``; the JAX trace hook is
not ported: ``torch.profiler`` serves there).

On a card, each ``tick`` records a ``torch.cuda.Event`` on the current
stream, after the step it closes was enqueued, and never waits for it: a
step's duration is the device time between two consecutive events, read
in ``stats`` (which waits for the last event only). On the CPU, each
``tick`` reads ``time.perf_counter``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

__all__ = ["StepTimer"]


class StepTimer:
    """Rolling step-latency/throughput stats for the training loop."""

    def __init__(self, window: int = 50, device=None):
        self.window = int(window)
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._spans: List[tuple] = []  # (start mark, end mark) a step
        self._items: List[float] = []
        self._last = None

    def tick(self, items: float = 0.0) -> None:
        """Call once per step; items = e.g. seconds of audio in the batch."""
        if self.cuda:
            now = torch.cuda.Event(enable_timing=True)
            now.record()
        else:
            now = time.perf_counter()
        if self._last is not None:
            self._spans.append((self._last, now))
            self._items.append(items)
            if len(self._spans) > self.window:
                self._spans.pop(0)
                self._items.pop(0)
        self._last = now

    def _durations(self) -> np.ndarray:
        if not self.cuda:
            return np.asarray([end - start for start, end in self._spans])
        self._last.synchronize()
        return np.asarray([start.elapsed_time(end) / 1000.0
                           for start, end in self._spans])

    def stats(self) -> Dict[str, float]:
        if not self._spans:
            return {}
        durations = self._durations()
        out: Dict[str, float] = {
            "step_ms_p50": float(np.percentile(durations, 50) * 1000),
            "step_ms_p95": float(np.percentile(durations, 95) * 1000),
            "steps_per_sec": float(1.0 / durations.mean()),
        }
        total_items = float(np.sum(self._items))
        if total_items > 0:
            out["items_per_sec"] = total_items / float(durations.sum())
        return out
