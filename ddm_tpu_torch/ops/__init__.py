"""Schedules, losses and the fused ops with their CUDA kernels (K1, K2, K3, K8, K10, K11, K12)."""
