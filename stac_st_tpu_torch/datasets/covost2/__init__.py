"""CoVoST2: the per-pair TSVs joined to a prepared CommonVoice manifest."""
