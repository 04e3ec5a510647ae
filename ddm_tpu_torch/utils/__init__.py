"""Checkpoints, the JAX-tree converter and the PNG grid writer."""
