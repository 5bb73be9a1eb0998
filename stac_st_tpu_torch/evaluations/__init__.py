"""Evaluation scripts of the port (``python -m stac_st_tpu_torch.evaluations.vad_shas.<script>``)."""
