"""Noise schedule and Gaussian-bridge math for DDDM (plain PyTorch).

Port of ``ddm_tpu/ops/schedules.py``: the linear flow-matching schedule
alpha(t) = 1 - t, sigma(t) = t (paper eq. (3)), the forward marginal
x_t = alpha_t x_0 + sigma_t eps (eq. (2)), and the Gaussian-bridge
transition mu_{s,t}, Sigma_{s,t} = std^2 I (eq. (4)) with churn eps_churn.
The bridge mean uses the linear sigma ratios of the corrected reference.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["alpha_sigma", "forward_marginal_sample", "gaussian_bridge_mu_sigma"]

_DIV_EPS = 1e-8  # division guard, as the JAX package and the reference

Scalar = Union[float, torch.Tensor]


def _bcast_right(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until ``x.dim() == ndim``."""
    if x.dim() > ndim:
        raise ValueError(f"cannot right-broadcast ndim {x.dim()} -> {ndim}")
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


def alpha_sigma(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(alpha, sigma) = (1 - t, t)``, broadcast to ``t.shape``."""
    t = torch.as_tensor(t)
    return 1.0 - t, t


def forward_marginal_sample(x0: torch.Tensor, t: Scalar, eps: torch.Tensor) -> torch.Tensor:
    """``x_t = alpha_t x_0 + sigma_t eps`` with ``t`` of shape ``[B]`` or scalar."""
    t = torch.as_tensor(t, dtype=x0.dtype, device=x0.device)
    a, s = alpha_sigma(t)
    return _bcast_right(a, x0.dim()) * x0 + _bcast_right(s, x0.dim()) * _bcast_right(eps, x0.dim())


def gaussian_bridge_mu_sigma(
    s: Scalar, t: Scalar, x0: torch.Tensor, xt: torch.Tensor, eps_churn: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bridge transition ``(mu, std)`` of eq. (4); ``std`` broadcasts against
    ``x0`` through trailing singleton dims, ``Sigma = std^2 I``."""
    dtype, device = x0.dtype, x0.device
    s = torch.as_tensor(s, dtype=dtype, device=device)
    t = torch.as_tensor(t, dtype=dtype, device=device)

    a_s, sig_s = alpha_sigma(s)
    a_t, sig_t = alpha_sigma(t)
    ratio = sig_s / (sig_t + _DIV_EPS)
    alpha_ratio = a_t / (a_s + _DIV_EPS)

    # eq. (4) coefficients; r11 == r21 and r12 == r22 under this schedule but
    # keep the paper's roles (see the JAX package)
    r11 = alpha_ratio * ratio
    r12 = alpha_ratio * ratio ** 2
    r21 = alpha_ratio * ratio
    r22 = alpha_ratio * ratio ** 2
    r01 = ratio
    e2 = eps_churn ** 2

    nd = x0.dim()
    b = lambda v: _bcast_right(v, nd)  # noqa: E731
    mu = (e2 * b(r12) + (1.0 - e2) * b(r01)) * xt + (
        b(a_s) * (1.0 - e2 * b(r22) - (1.0 - e2) * b(r21)) * x0
    )

    inner = e2 * r11 + (1.0 - e2)
    var = (sig_s ** 2) * torch.clamp(1.0 - inner ** 2, min=0.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return mu, b(std)
