"""Runnable examples of the port: ``python -m stac_st_tpu_torch.examples.quickstart``."""
