"""Cross-dataset mixtures: per-pair unions, the all-to-all union, multi-turn variants."""
