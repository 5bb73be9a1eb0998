"""The serving data mesh (port of ``stac_st_tpu/parallel/mesh.py``'s data
axis).

The JAX engine takes a ``Mesh`` with a ``data`` axis: parameters are
replicated on every device and each request batch is sharded on its rows.
The port's :class:`DataMesh` is the list of devices of that axis, one
shard each, in one process: ``STEngine(mesh=make_mesh())`` keeps one copy
of the modules on each distinct device and runs each shard's row block on
its device. A device may repeat: two shards on one card (or on the CPU)
run their row blocks one beside the other on that device, which is how a
one-card machine and the CPU tests exercise the meshed path.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

__all__ = ["DataMesh", "make_mesh", "row_blocks", "device_scope"]


class DataMesh:
    """The devices of a data axis, one per shard; ``shape["data"]`` is the
    shard count, as on a JAX mesh."""

    def __init__(self, devices: Iterable):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a DataMesh needs at least one device")
        self.shape = {"data": len(self.devices)}

    @property
    def distinct(self) -> List[torch.device]:
        """Each device once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"DataMesh({[str(d) for d in self.devices]})"


def make_mesh(data: int = -1, devices: Optional[Sequence] = None
              ) -> DataMesh:
    """A data axis of ``data`` shards over ``devices`` (default: every
    visible card); ``data=-1`` takes them all."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise ValueError("make_mesh: no visible CUDA card; pass devices=")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    data = len(devices) if int(data) == -1 else int(data)
    if not 1 <= data <= len(devices):
        raise ValueError(f"make_mesh: data={data} shards over "
                         f"{len(devices)} devices")
    return DataMesh(devices[:data])


def row_blocks(n_rows: int, shards: int) -> List[Tuple[int, int]]:
    """The (lo, hi) rows of each shard; ``n_rows`` must be a multiple of
    ``shards`` (the counterpart of ``batch_sharding``'s row split)."""
    if n_rows % shards:
        raise ValueError(f"{n_rows} rows do not split over {shards} shards")
    per = n_rows // shards
    return [(i * per, (i + 1) * per) for i in range(shards)]


def device_scope(device) -> contextlib.AbstractContextManager:
    """Make ``device`` the calling thread's current CUDA device (the kernel
    wrappers launch on the current device's stream); nothing on the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
