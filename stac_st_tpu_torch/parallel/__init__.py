"""Multi-process helpers (only the row partition the loader needs so far)."""
