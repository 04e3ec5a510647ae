"""Checkpoints, the JAX-tree converter, the config merge and the PNG grid writer."""
