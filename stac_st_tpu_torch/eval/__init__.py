"""Evaluation of long-form output (host-side): realignment, speaker-change
metrics, aligned RTTM."""

from .speaker_change import (
    TOLERANCE_GRID,
    ChangePointMetrics,
    evaluate_speaker_change,
    evaluate_speaker_turn_detection,
    score_change_points,
)

__all__ = [
    "TOLERANCE_GRID",
    "ChangePointMetrics",
    "evaluate_speaker_change",
    "evaluate_speaker_turn_detection",
    "score_change_points",
]
