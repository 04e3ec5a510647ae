"""Generalized energy-score loss terms for DDDM (plain PyTorch).

Port of ``ddm_tpu/ops/losses.py``: the conditional generalized energy score
of the paper (eqs. (12)-(14)) split into its confinement term
``E ||x0 - x0_hat||^beta`` and its interaction term
``E ||x0_hat_i - x0_hat_j||^beta`` (off-diagonal pairs only), and the
logistic time weight ``w(t)``.

Squared distances come from direct differences only: the Gram expansion
``|a|^2 + |b|^2 - 2 a.b`` carries cancellation noise that, under the
``(d2)^(beta/2 - 1)`` factor of a fractional beta's gradient, diverged
training (``ddm_tpu/ops/losses.py:10-21``). Reductions are fp32 with the
reference's 1e-12 stabiliser inside the fractional power; ``beta == 2``
takes the exact path. Above 2^28 elements of the (B, m, m, D) difference
tensor the interaction term walks one anchor row at a time, so memory
stays O(B m D).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .schedules import alpha_sigma

__all__ = ["generalized_energy_terms", "pairwise_sqdist", "sigmoid_weight"]

STAB_EPS = 1e-12  # fractional-power stabiliser (reference losses.py:14,24)
DIRECT_PAIR_ELEMS = 2 ** 28


def pow_beta(d2: torch.Tensor, beta: float) -> torch.Tensor:
    """``(d2 + 1e-12)^(beta / 2)``, exactly ``d2`` at ``beta == 2``."""
    return d2 if beta == 2.0 else torch.pow(d2 + STAB_EPS, beta / 2.0)


def pairwise_sqdist(x: torch.Tensor) -> torch.Tensor:
    """All-pairs squared distances of ``x: (B, m, D)`` -> ``(B, m, m)``, from
    direct differences."""
    diff = x[:, :, None, :] - x[:, None, :, :]
    return (diff * diff).sum(-1)


def _interaction_mean_chunked(x: torch.Tensor, beta: float) -> torch.Tensor:
    """Off-diagonal mean of ``||x_i - x_j||^beta`` over a (B, m, D) fp32 set,
    one anchor row at a time (each unordered pair visited twice, as the
    direct form counts it)."""
    B, m, _ = x.shape
    total = x.new_zeros(())
    for i in range(m):
        diff = x - x[:, i:i + 1, :]
        powed = pow_beta((diff * diff).sum(-1), beta)  # (B, m)
        mask = torch.ones(m, dtype=x.dtype, device=x.device)
        mask[i] = 0.0
        total = total + (powed * mask).sum()
    return total / (B * m * (m - 1))


def generalized_energy_terms(x0hats: torch.Tensor, x0: torch.Tensor,
                             beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(conf, inter)`` fp32 scalars of the energy score (paper eq. (12)):
    ``conf = mean_{b,i} ||x0_b - x0hat_{b,i}||^beta`` and
    ``inter = mean_{b, i != j} ||x0hat_{b,i} - x0hat_{b,j}||^beta`` for
    predictions ``(B, m, D)`` and targets ``(B, D)``."""
    B, m, _ = x0hats.shape
    xh = x0hats.float()
    diff = x0[:, None, :].float() - xh
    conf = pow_beta((diff * diff).sum(-1), beta).mean()
    if x0hats.numel() * m > DIRECT_PAIR_ELEMS:
        return conf, _interaction_mean_chunked(xh, beta)
    powed = pow_beta(pairwise_sqdist(xh), beta)
    offdiag = 1.0 - torch.eye(m, dtype=torch.float32, device=xh.device)
    return conf, (powed * offdiag).sum() / (B * m * (m - 1))


def sigmoid_weight(t: torch.Tensor, bias: float = 0.0) -> torch.Tensor:
    """Logistic time weight ``w(t) = sigmoid(log(alpha^2 / sigma^2) - bias)``
    with both 1e-12 guards (reference losses.py:28-35)."""
    a, s = alpha_sigma(torch.as_tensor(t))
    ratio = (a * a) / (s * s + STAB_EPS)
    return torch.sigmoid(torch.log(ratio + STAB_EPS) - bias)
