"""Host-side helpers."""
