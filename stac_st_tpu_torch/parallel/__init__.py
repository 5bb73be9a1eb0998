"""Data parallelism: process groups for training, the device mesh for
serving."""
