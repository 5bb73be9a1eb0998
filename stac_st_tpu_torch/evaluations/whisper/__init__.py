"""The Whisper baseline (BLEU / WER over a manifest)."""
