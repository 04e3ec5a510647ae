"""Reverse-time DDDM sampler (paper Algorithm 2) in PyTorch.

Port of ``ddm_tpu/sampling.py``: a uniform grid ``t_0 = 0 < ... < t_N = 1``;
from ``x ~ N(0, I)`` each reverse step ``k = N-1 ... 0`` draws a fresh latent
``xi``, queries ``x_hat_0 = model(x, t_{k+1}, xi)``, computes the Gaussian
bridge ``(mu, std)`` with the *prediction* in the ``x0`` slot, and resamples
``x = mu + std * z``. The loop is a plain Python loop under
``torch.inference_mode()``; the state is fp32. Random numbers come from an
explicit ``torch.Generator``, or from ``noise`` when a caller injects them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.schedules import gaussian_bridge_mu_sigma

__all__ = ["sample_dddm", "sample_dddm_batched"]

Denoiser = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# x_init and the per-step (xi, z), in the order the loop consumes them
Noise = Tuple[torch.Tensor, Sequence[Tuple[torch.Tensor, torch.Tensor]]]


def sample_dddm(
    model: Denoiser,
    n_samples: int,
    *,
    steps: int = 20,
    eps_churn: float = 1.0,
    data_shape: Tuple[int, ...] = (2,),
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
    noise: Optional[Noise] = None,
) -> torch.Tensor:
    """Draw ``n_samples`` with a ``steps``-step reverse grid.

    ``noise = (x_init, [(xi, z) for each step])`` replaces the draws from
    ``generator`` (step order ``k = steps-1 ... 0``), so a test can feed the
    same numbers to another implementation.
    """
    device = torch.device(device)
    shape = (n_samples,) + tuple(data_shape)

    def normal():
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    if noise is not None:
        x_init, per_step = noise
        if len(per_step) != steps:
            raise ValueError(f"noise has {len(per_step)} steps, expected {steps}")
    t_grid = torch.linspace(0.0, 1.0, steps + 1, dtype=torch.float32)

    with torch.inference_mode():
        x = (x_init.to(device, torch.float32) if noise is not None else normal())
        for i, k in enumerate(range(steps - 1, -1, -1)):
            s, t = t_grid[k].item(), t_grid[k + 1].item()
            if noise is not None:
                xi, z = (a.to(device, torch.float32) for a in per_step[i])
            else:
                xi = normal()
            xhat0 = model(x, torch.full((n_samples,), t, device=device), xi)
            mu, std = gaussian_bridge_mu_sigma(s, t, xhat0.float(), x, eps_churn=eps_churn)
            if noise is None:
                z = normal()
            x = mu + std * z
    return x


def sample_dddm_batched(
    model: Denoiser,
    n_samples: int,
    *,
    steps: int = 20,
    eps_churn: float = 1.0,
    data_shape: Tuple[int, ...] = (2,),
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
    chunk_size: int = 2048,
) -> np.ndarray:
    """Sample in fixed-size chunks (the last one padded and trimmed, so every
    chunk has one shape) and gather them on the host as numpy."""
    chunk_size = min(chunk_size, n_samples)
    out, produced = [], 0
    while produced < n_samples:
        x = sample_dddm(model, chunk_size, steps=steps, eps_churn=eps_churn,
                        data_shape=data_shape, generator=generator, device=device)
        take = min(chunk_size, n_samples - produced)
        out.append(x[:take].cpu().numpy())
        produced += take
    return np.concatenate(out, axis=0)
