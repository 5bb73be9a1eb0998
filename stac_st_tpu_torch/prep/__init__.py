"""Corpus preparation (port of ``stac_st_tpu/prep/``): the Fisher and
CALLHOME parsers, cleaning, turn concatenation and manifests, and the
long-form segmentation chain (pause-based VAD, SHAS pDAC, masking,
resegmented manifests). Host-side numpy and Python, byte-equal output to
the JAX package's."""

from .records import Utterance, write_manifests
from .turns import concatenate_turns

__all__ = ["Utterance", "write_manifests", "concatenate_turns"]
