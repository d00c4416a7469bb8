"""Checkpoints of the train state, and weights across from the JAX package
(.pth load/save)."""
