"""The engine parity tests of ``test_torch_engine.py`` at beam 1.

A file of its own so that its JAX reference engine compiles on another
test worker than the beam-4 one.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_engine import (  # noqa: E402,F401  (run here at BEAM)
    _torch_threads,
    engines,
    shared,
    test_inputs_fall_in_two_buckets,
    test_speaker_turns_matches_jax,
    test_transcribe_and_translate_matches_jax,
    test_transcribe_matches_jax,
    test_translate_matches_jax,
)

BEAM = 1
