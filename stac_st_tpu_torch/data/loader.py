"""Batch loader: sampler indices -> collated static-shape batches,
prefetched (port of ``stac_st_tpu/data/loader.py``).

``num_workers`` threads read, resample and collate batches concurrently
while an ordered in-flight window keeps the batch order deterministic and
bounds memory to ``prefetch + num_workers`` batches; ``num_workers <= 1``
keeps one producer thread. Threads, not ``torch.utils.data.DataLoader``'s
worker processes: the dataset's ``epoch`` (which keys the speed draw) is
set by :meth:`BatchLoader.set_epoch` and read by every worker, and the
numpy and BLAS work of reading and resampling releases the interpreter
lock.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from ..parallel.distributed import process_row_block
from .dataset import PaddedBatch, SpeechDataset, collate_batch
from .sampler import DynamicBatchSampler

__all__ = ["BatchLoader"]

_SENTINEL = object()


class BatchLoader:
    def __init__(
        self,
        dataset: SpeechDataset,
        sampler: Optional[DynamicBatchSampler] = None,
        batch_size: int = 4,
        sample_rate: int = 16000,
        token_pad_multiple: int = 32,
        prefetch: int = 2,
        drop_last: bool = False,
        shuffle: bool = False,
        seed: int = 8886,
        num_workers: int = 1,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.sample_rate = int(sample_rate)
        self.token_pad_multiple = int(token_pad_multiple)
        self.prefetch = int(prefetch)
        self.drop_last = bool(drop_last)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.num_workers = int(num_workers)
        self.epoch = 0
        self.order = None  # fixed index order (sorting modes)
        self._shard = None  # (process_index, process_count, row_multiple)

    def set_shard(self, index: int, count: int, row_multiple: int) -> None:
        """Multi-process IO sharding: decode audio only for this process's
        row block of each GLOBAL batch.

        Every process iterates the same (identically-seeded) sampler and
        builds the same batch composition, but rows outside
        ``[index·per, (index+1)·per)`` — ``per`` computed after padding
        the row count to ``row_multiple`` (the trainer's mesh multiple,
        so blocks line up with ``_device_batch``'s process slices) — get
        zero audio of the manifest-duration length instead of a decode.
        Tokens/text/metadata stay real for every row (metrics need
        them). Effective only for bucket-sampled loading, where the
        audio width is fixed by the bucket rather than the decoded
        lengths; otherwise full decode is kept (correctness first).
        """
        if not (0 <= index < count):
            raise ValueError(f"shard index {index} not in [0, {count})")
        if row_multiple % count:
            raise ValueError(
                f"row_multiple {row_multiple} not divisible by "
                f"shard count {count}")
        self._shard = (int(index), int(count), int(row_multiple))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)
        # the dataset's epoch keys the per-utterance speed-perturb draw
        self.dataset.epoch = int(epoch)
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _index_batches(self):
        if self.sampler is not None:
            yield from self.sampler
            return
        order = (
            np.asarray(self.order)
            if self.order is not None
            else np.arange(len(self.dataset))
        )
        if self.shuffle and self.order is None:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        for i in range(0, len(order), self.batch_size):
            chunk = list(map(int, order[i : i + self.batch_size]))
            if self.drop_last and len(chunk) < self.batch_size:
                continue
            yield chunk

    def _make_batch(self, indices) -> PaddedBatch:
        width = None
        if self.sampler is not None:
            spec = self.sampler.bucket_of(indices[0])
            width = int(np.ceil(spec.boundary * self.sample_rate))
        if self._shard is not None and width is not None:
            pi, count, mult = self._shard
            lo, hi = process_row_block(len(indices), mult, pi, count)
            samples = [
                self.dataset[i] if lo <= pos < hi
                else self.dataset.sample(i, skip_audio=True,
                                         audio_cap=width)
                for pos, i in enumerate(indices)
            ]
        else:
            samples = [self.dataset[i] for i in indices]
        return collate_batch(
            samples,
            audio_pad_samples=width,
            token_pad_multiple=self.token_pad_multiple,
        )

    def __iter__(self) -> Iterator[PaddedBatch]:
        if self.num_workers > 1:
            yield from self._iter_pooled()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        error_holder = []

        def producer():
            try:
                for indices in self._index_batches():
                    q.put(self._make_batch(indices))
            except BaseException as exc:  # propagate to consumer
                error_holder.append(exc)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                if error_holder:
                    raise error_holder[0]
                return
            yield item

    def _iter_pooled(self) -> Iterator[PaddedBatch]:
        """num_workers decode threads; ordered bounded in-flight window."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window: deque = deque()
            index_iter = self._index_batches()
            limit = self.prefetch + self.num_workers
            try:
                for indices in index_iter:
                    window.append(pool.submit(self._make_batch, indices))
                    if len(window) >= limit:
                        yield window.popleft().result()
                while window:
                    yield window.popleft().result()
            finally:
                for fut in window:
                    fut.cancel()

    def __len__(self) -> int:
        if self.sampler is not None:
            return len(self.sampler)
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)
