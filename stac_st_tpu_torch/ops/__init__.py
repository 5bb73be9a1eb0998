"""Feature extraction, masks, losses, augmentation (SpecAugment, speed
perturbation) and the attention kernels."""
