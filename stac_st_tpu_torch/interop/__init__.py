"""Loading weights from the JAX reference."""
