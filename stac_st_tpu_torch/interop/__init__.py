"""Weights across packages: the JAX reference's trees (``from_jax``) and
SpeechBrain checkpoints (``sb_import``, ``sb_export``)."""
