"""Schedules and the fused DiT half-block ops (kernels K1, K2)."""
