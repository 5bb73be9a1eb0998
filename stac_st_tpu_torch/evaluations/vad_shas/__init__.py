"""Long-form (VAD/SHAS-segmented) evaluation: speaker-change F1, realigned BLEU/WER, the full protocol."""
