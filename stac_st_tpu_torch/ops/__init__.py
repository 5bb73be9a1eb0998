"""Feature extraction, masks and the decode-attention kernels."""
