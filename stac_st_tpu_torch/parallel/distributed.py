"""Process groups for data-parallel training (port of
``stac_st_tpu/parallel/distributed.py``).

The JAX package's data axis spans every device of a mesh, and its
processes join through ``jax.distributed.initialize``. The port's data
axis is one process per card, as ``torchrun`` launches it::

    torchrun --nproc_per_node 8 -m stac_st_tpu_torch.recipes.train_multitask \\
        recipes/hparams/transformer_multitask.yaml --data_folder=...

:func:`init_distributed` joins the process group (a single process is a
no-op); :class:`DataParallel` is one rank's view of it that the train step
reads: its row block of each global batch and the all-reduces that make
the rank's step compute what the whole batch computes on one device. The
loader's ``set_shard`` and the trainer's ``_device_batch`` read the same
row partition, :func:`process_row_block`.

The backend is explicit: ``nccl`` (one card per rank) unless the caller
names ``gloo``; the library never falls back to gloo by itself.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

__all__ = ["init_distributed", "is_main_process", "process_count",
           "process_index", "barrier", "gather_to_host", "process_row_block",
           "DataParallel", "data_parallel"]

LAUNCH_HINT = ("launch one process per card: torchrun --nproc_per_node N "
               "-m stac_st_tpu_torch.recipes.train_multitask HPARAMS.yaml ...")


def process_row_block(n_rows: int, row_multiple: int,
                      index: int, count: int):
    """The (lo, hi) row block process ``index`` of ``count`` owns in a
    global batch of ``n_rows`` rows, after padding the rows to a multiple
    of ``row_multiple`` (which ``count`` must divide)."""
    if row_multiple % count:
        raise ValueError(
            f"row_multiple {row_multiple} not divisible by count {count}")
    padded = -(-int(n_rows) // int(row_multiple)) * int(row_multiple)
    per = padded // int(count)
    return index * per, (index + 1) * per


def init_distributed(backend: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     init_method: Optional[str] = None) -> bool:
    """Join the process group; returns whether this run has several ranks.

    Arguments left out are read from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``). A world of one
    process is a no-op, as in the JAX package. ``backend`` defaults to
    ``nccl``, which takes one card per local rank and sets this process's
    current device to ``cuda:<local_rank>``; fewer visible cards than
    local ranks raise. ``gloo`` runs only when named (the CPU tests, or
    several ranks sharing one card)."""
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    rank = int(rank if rank is not None else env["RANK"])
    local = int(local_rank if local_rank is not None
                else env.get("LOCAL_RANK", rank))
    backend = backend or "nccl"
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        if max(local + 1, local_world) > cards:
            raise ValueError(
                f"backend nccl needs one card per local rank: "
                f"{local_world} local ranks, {cards} visible cards (name "
                f"backend='gloo' to share cards)")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    logger.info("joined the process group: rank %d of %d (%s)", rank, world,
                backend)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def gather_to_host(x: Any) -> Any:
    """Every rank's ``x`` concatenated in rank order, i.e. in global row
    order, on every rank: arrays and tensors along axis 0 (as numpy), lists
    as one list. One process: ``x`` itself (a tensor as numpy)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if process_count() == 1:
        return x
    parts: List[Any] = [None] * process_count()
    dist.all_gather_object(parts, x)
    if isinstance(x, np.ndarray):
        return np.concatenate(parts, axis=0)
    return [item for part in parts for item in part]


class DataParallel(NamedTuple):
    """One rank's place in the data axis: ``rank`` of ``world``, each rank
    holding an equal row block of the (padded) global batch."""

    rank: int
    world: int

    def rows(self, n_local: int) -> Tuple[int, int]:
        """(first global row of this rank, global row count)."""
        return self.rank * n_local, self.world * n_local

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place (sum over ranks) and return it."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t

    def sum_async(self, t: torch.Tensor):
        """Dispatch the in-place sum of ``t``; returns the work handle
        (``wait()`` before reading ``t``)."""
        return dist.all_reduce(t, op=dist.ReduceOp.SUM, async_op=True)


def data_parallel(count: int = -1) -> Optional[DataParallel]:
    """The rank's :class:`DataParallel` for ``data_parallel_count``
    (-1: the process group's world size; any other value must equal it),
    or None for a single process."""
    world = process_count()
    count = int(count)
    if count not in (-1, world):
        raise ValueError(
            f"data_parallel_count={count} but the process group has "
            f"{world} rank(s): {LAUNCH_HINT} with N = {count}")
    return DataParallel(process_index(), world) if world > 1 else None
