"""Batches: the reference's padded batch surface and its collation."""

from .dataset import PaddedBatch, collate_batch, pad_batch_rows

__all__ = ["PaddedBatch", "collate_batch", "pad_batch_rows"]
