"""Training loggers (reference ``utils.train_logger.FileTrainLogger``;
copy of ``stac_st_tpu/utils/logger.py``).

Writes one epoch-summary line per validation to a text file and stdout
(reference ``transformer_multitask.yaml:305-306``,
``train_multitask.py:415-419``), same ``key: value - `` format family.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

logger = logging.getLogger("stac_st_tpu_torch")

__all__ = ["FileTrainLogger"]


def _fmt(value) -> str:
    if isinstance(value, float):
        return f"{value:.2f}" if abs(value) >= 1e-2 else f"{value:.2e}"
    return str(value)


class FileTrainLogger:
    def __init__(self, save_file: str, precision: int = 2, **unused):
        self.save_file = save_file
        self.precision = precision

    def log_stats(
        self,
        stats_meta: Dict,
        train_stats: Optional[Dict] = None,
        valid_stats: Optional[Dict] = None,
        test_stats: Optional[Dict] = None,
    ) -> None:
        parts = [f"{k}: {_fmt(v)}" for k, v in stats_meta.items()]
        for name, stats in (
            ("train", train_stats), ("valid", valid_stats),
            ("test", test_stats),
        ):
            if stats:
                parts.extend(f"{name} {k}: {_fmt(v)}" for k, v in stats.items())
        line = ", ".join(parts)
        os.makedirs(os.path.dirname(self.save_file) or ".", exist_ok=True)
        with open(self.save_file, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)
