"""Small trainer-lifecycle objects instantiated from YAML (copy of
``stac_st_tpu/training/lifecycle.py``).

``EpochCounter`` (reference ``utils.epoch_loop.EpochCounter``, yaml:280-281)
and ``Pretrainer`` (``utils.parameter_transfer.Pretrainer``, yaml:314-319 —
fetches the tokenizer ``.model`` into the experiment save dir and loads it).
Under data parallelism rank 0 collects the files and every rank waits for
it before loading them.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

from ..parallel.distributed import barrier, is_main_process

__all__ = ["EpochCounter", "Pretrainer", "Stage"]


class Stage:
    TRAIN = "TRAIN"
    VALID = "VALID"
    TEST = "TEST"


class EpochCounter:
    """Iterating yields 1, 2, ... limit; ``current`` is checkpointable."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.current = 0

    def __iter__(self):
        return self

    def __next__(self) -> int:
        if self.current < self.limit:
            self.current += 1
            return self.current
        raise StopIteration

    def state_dict(self) -> Dict[str, Any]:
        return {"current": self.current}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.current = int(state.get("current", 0))


class Pretrainer:
    def __init__(
        self,
        collect_in: str,
        loadables: Optional[Dict[str, Any]] = None,
        paths: Optional[Dict[str, str]] = None,
        **unused,
    ):
        self.collect_in = collect_in
        self.loadables = loadables or {}
        self.paths = paths or {}
        self._collected: Dict[str, str] = {}

    def collect_files(self) -> Dict[str, str]:
        write = is_main_process()
        if write:
            os.makedirs(self.collect_in, exist_ok=True)
        for name, src in self.paths.items():
            dst = os.path.join(self.collect_in, f"{name}.ckpt")
            if write and os.path.abspath(src) != os.path.abspath(dst):
                if os.path.islink(dst) or os.path.isfile(dst):
                    os.remove(dst)
                try:
                    os.symlink(os.path.abspath(src), dst)
                except OSError:
                    shutil.copyfile(src, dst)
            self._collected[name] = dst
        barrier()
        return self._collected

    def load_collected(self, device=None) -> None:
        for name, obj in self.loadables.items():
            path = self._collected.get(name)
            if path is None:
                path = os.path.join(self.collect_in, f"{name}.ckpt")
            if hasattr(obj, "load"):
                obj.load(path)
            else:
                raise TypeError(f"loadable {name!r} has no .load()")
