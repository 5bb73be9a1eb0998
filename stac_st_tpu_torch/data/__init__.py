"""Data IO: audio decode, manifests, datasets, bucketed batching, text."""

from .audio import read_audio, read_sphere, read_wav, resample, write_wav
from .dataset import (
    PaddedBatch,
    SpeechDataset,
    collate_batch,
    pad_batch_rows,
    sort_ids,
)
from .loader import BatchLoader
from .manifest import load_manifest, split_name, wav_paths
from .sampler import BucketSpec, DynamicBatchSampler
from .text import (
    add_special_tokens,
    build_target_ids,
    lang_token_id,
    strip_special_tokens,
)

__all__ = [
    "read_audio", "read_sphere", "read_wav", "resample", "write_wav",
    "PaddedBatch", "SpeechDataset", "collate_batch", "pad_batch_rows",
    "sort_ids", "BatchLoader", "load_manifest", "split_name", "wav_paths",
    "BucketSpec", "DynamicBatchSampler", "add_special_tokens",
    "build_target_ids", "lang_token_id", "strip_special_tokens",
]
