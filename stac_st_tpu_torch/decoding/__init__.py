"""Prompted, KV-cached beam search."""
