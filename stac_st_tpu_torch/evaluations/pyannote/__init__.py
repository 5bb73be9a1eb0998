"""The pyannote speaker-change baseline (segmentation + SCD, or diarization)."""
