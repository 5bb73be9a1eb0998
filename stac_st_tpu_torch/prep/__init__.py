"""Host-side preparation of long-form audio (segmentation)."""
