"""The DiT denoiser and its factory."""
