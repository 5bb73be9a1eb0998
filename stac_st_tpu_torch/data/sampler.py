"""Duration-bucketed batching with static shapes (a copy of
``stac_st_tpu/data/sampler.py``).

Re-owns SpeechBrain's ``DynamicBatchSampler`` exactly as the reference
configures it (``dataio_and_utils.py:203-231``, yaml:104-115): batches hold
≈ ``max_batch_len`` seconds of audio drawn from ``num_buckets`` duration
buckets, capped at ``max_batch_ex`` utterances, with per-epoch example
reshuffling and random batch ordering.

SB-exact semantics (gated by tests/test_sampler_gate.py against a
straight-line transcription of the SB algorithm):

* bucket boundaries are *warped quantiles* of a lognorm(σ=1) latent —
  ``lognorm.ppf(linspace(1/(N+1), N/(N+1), N))`` scaled so the last
  boundary equals ``max_batch_length`` — NOT dataset quantiles;
* per-bucket batch size is ``max(1, int(max_batch_length / boundary))``
  with items longer than the last boundary falling into an overflow bucket
  of batch size 1;
* a bucket flushes when it reaches its batch size or ``max_batch_ex``;
  leftovers are emitted in bucket order unless ``drop_last``;
* example shuffling and random batch ordering both draw from one
  ``torch.Generator`` seeded ``seed + epoch`` (SB default seed 42) —
  epoch composition is bit-reproducible and matches SB run-for-run.

Static shapes: every bucket also has a *fixed* padded audio length (its
boundary; dataset max for the overflow bucket), so a train step sees at
most ``num_buckets + 1`` distinct batch widths, and the boundaries are
dataset-independent. ``boundaries="quantile"`` keeps the empirical mode.

The shuffle's ``torch.Generator`` stays on the CPU: a CUDA generator
gives another permutation from the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

__all__ = ["DynamicBatchSampler", "BucketSpec", "sb_warped_boundaries"]


def sb_warped_boundaries(max_batch_length: float,
                         num_quantiles: int) -> List[float]:
    """SB's latent-space bucket boundaries: lognorm(σ=1) quantiles at
    ``linspace(1/(N+1), N/(N+1), N)`` scaled to ``max_batch_length``."""
    from scipy.stats import lognorm

    num_boundaries = num_quantiles + 1
    latent = np.linspace(
        1.0 / num_boundaries, num_quantiles / num_boundaries, num_quantiles
    )
    quantiles = lognorm.ppf(latent, 1)
    bounds = quantiles * max_batch_length / quantiles[-1]
    return sorted(float(b) for b in bounds)


class BucketSpec:
    __slots__ = ("boundary", "batch_size")

    def __init__(self, boundary: float, batch_size: int):
        self.boundary = float(boundary)
        self.batch_size = int(batch_size)

    def __repr__(self) -> str:  # pragma: no cover
        return f"BucketSpec(≤{self.boundary:.2f}s, bs={self.batch_size})"


def _randperm(n: int, generator) -> List[int]:
    """torch.randperm when torch is present (SB parity), numpy otherwise."""
    if generator is not None:
        import torch

        return torch.randperm(n, generator=generator).tolist()
    return list(np.random.default_rng().permutation(n))


class DynamicBatchSampler:
    """Yields lists of dataset indices; exposes static bucket shapes."""

    def __init__(
        self,
        lengths: Sequence[float],
        max_batch_length: float,
        num_buckets: int = 50,
        shuffle: bool = True,
        batch_ordering: str = "random",
        max_batch_ex: int = 128,
        seed: int = 42,
        drop_last: bool = False,
        boundaries: str = "sb_warped",
    ):
        self.lengths = np.asarray(lengths, np.float64)
        self.max_batch_length = float(max_batch_length)
        self.shuffle = bool(shuffle)
        self.batch_ordering = batch_ordering
        self.max_batch_ex = int(max_batch_ex)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.epoch = 0

        if len(self.lengths) == 0:
            raise ValueError("empty dataset")
        if boundaries == "sb_warped":
            bounds = sb_warped_boundaries(
                self.max_batch_length, int(num_buckets)
            )
        elif boundaries == "quantile":
            nb = max(1, min(int(num_buckets),
                            len(np.unique(self.lengths))))
            qs = np.quantile(self.lengths, np.linspace(0, 1, nb + 1)[1:])
            bounds = list(np.unique(qs))
            bounds[-1] = float(self.lengths.max())
        else:
            raise ValueError(f"unknown boundaries mode {boundaries!r}")

        self._boundaries = np.asarray(bounds, np.float64)
        # per-bucket batch size (SB _bucket_lens) + overflow bucket of 1
        bucket_lens = [
            max(1, int(self.max_batch_length / b)) for b in self._boundaries
        ] + [1]
        # overflow items pad to the dataset maximum
        pad_bounds = list(self._boundaries) + [float(self.lengths.max())]
        self.buckets: List[BucketSpec] = [
            BucketSpec(b, min(bs, self.max_batch_ex))
            for b, bs in zip(pad_bounds, bucket_lens)
        ]
        self._assign = np.searchsorted(
            self._boundaries, self.lengths, side="left"
        )

    # ------------------------------------------------------------------ api
    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def bucket_of(self, index: int) -> BucketSpec:
        return self.buckets[self._assign[index]]

    def bucket_shapes(self, sample_rate: int = 16000) -> List[Dict]:
        """Static (batch_size, padded_samples) per bucket — the compile set."""
        return [
            {
                "batch_size": b.batch_size,
                "boundary_sec": b.boundary,
                "padded_samples": int(np.ceil(b.boundary * sample_rate)),
            }
            for b in self.buckets
        ]

    def _generate_batches(self) -> List[List[int]]:
        generator = None
        if self.shuffle or self.batch_ordering == "random":
            try:
                import torch

                generator = torch.Generator()
                generator.manual_seed(self.seed + self.epoch)
            except ImportError:  # pragma: no cover
                generator = None
        if self.shuffle:
            order = _randperm(len(self.lengths), generator)
        else:
            order = range(len(self.lengths))

        per_bucket: List[List[int]] = [[] for _ in self.buckets]
        batches: List[List[int]] = []
        for idx in order:
            b = self._assign[idx]
            per_bucket[b].append(int(idx))
            if (
                len(per_bucket[b]) >= self.buckets[b].batch_size
                or len(per_bucket[b]) >= self.max_batch_ex
            ):
                batches.append(per_bucket[b])
                per_bucket[b] = []
        if not self.drop_last:
            for leftover in per_bucket:
                if leftover:
                    batches.append(leftover)

        if self.batch_ordering == "random":
            perm = _randperm(len(batches), generator)
            batches = [batches[i] for i in perm]
        elif self.batch_ordering == "descending":
            batches.sort(key=lambda bb: -max(self.lengths[i] for i in bb))
        elif self.batch_ordering == "ascending":
            batches.sort(key=lambda bb: max(self.lengths[i] for i in bb))
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        batches = self._generate_batches()
        self._last_num_batches = len(batches)
        return iter(batches)

    def __len__(self) -> int:
        sizes = np.bincount(self._assign, minlength=len(self.buckets))
        total = 0
        for count, spec in zip(sizes, self.buckets):
            full, rem = divmod(int(count), spec.batch_size)
            total += full + (0 if self.drop_last or rem == 0 else 1)
        return total
