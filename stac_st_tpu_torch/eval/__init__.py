"""Evaluation helpers of long-form output (host-side)."""
