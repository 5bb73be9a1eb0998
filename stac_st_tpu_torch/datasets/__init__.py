"""Dataset preparation scripts of the port (``python -m stac_st_tpu_torch.datasets.<corpus>.<script>``)."""
