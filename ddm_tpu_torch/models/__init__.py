"""The DiT denoiser, its MoE layer and its factory."""
