"""Speaker-turn RTTM events from CTC frame argmaxes (port of
``stac_st_tpu/utils/rttm.py``).

The encoder's CTC head runs at 25 Hz (100 Hz fbank, 4x conv
downsampling); frames whose argmax is the ``[turn]`` / ``[xt]`` token
become time-aligned events. Utterance ids carry the absolute start time in
centiseconds as their third '-'-separated field.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["extract_turn_events", "DOWNSAMPLING"]

DOWNSAMPLING = 25  # encoder frames per second


def extract_turn_events(ids: Sequence[str], ctc_argmax: np.ndarray,
                        token_ids: Dict[str, int],
                        downsampling: int = DOWNSAMPLING
                        ) -> Dict[str, List[str]]:
    """ctc_argmax: (B, T) frame argmax ids. Returns {name: [rttm lines]}."""
    out: Dict[str, List[str]] = {name: [] for name in token_ids}
    frame = 1.0 / downsampling
    for b, utt_id in enumerate(ids):
        parts = utt_id.split("-")
        try:
            abs_start = int(parts[2]) / 100.0
        except (IndexError, ValueError):
            abs_start = 0.0
        for name, token in token_ids.items():
            for t in np.nonzero(ctc_argmax[b] == token)[0]:
                start = abs_start + t * frame
                out[name].append(
                    f"SPEAKER {utt_id} 1 {start:.3f} {frame} "
                    f"<NA> <NA> SPK1 <NA> <NA>"
                )
    return out
