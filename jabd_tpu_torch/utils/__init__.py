"""Utilities of the port: weight conversion from and to the JAX package's
variables, checkpoints, the training loss log."""
