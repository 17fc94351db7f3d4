"""Training utilities of the port (so far: the optimizers)."""
