"""Fused generalized energy-score terms with their gradient (kernels K3, K9).

Port of ``ddm_tpu/ops/energy.py`` ``fused_energy_terms``. It is a
``torch.autograd.Function`` over fp32 predictions ``(B, m, D)`` and targets
``(B, D)`` that returns ``(conf, inter)`` with the contract of
:func:`ddm_tpu_torch.ops.losses.generalized_energy_terms`, dispatched as the
JAX package dispatches (:func:`energy_route`):

- where the JAX gate for its K3 kernel holds (:func:`jax_kernel_gate`,
  2 <= m <= 16 and its VMEM bound), CUDA tensors launch K3f and K3b;
- else, where the gate for its anchor-streaming kernel K9 holds
  (:func:`jax_stream_gate`, 16 < m <= 64), CUDA tensors launch K9f and K9b;
- else (m = 17, m > 64, m = 32 at 128 px) the JAX package runs its jnp
  path, and the port its plain version, on the device too.

K3 and K9 are one D-tiled design in ``csrc/energy.cu``, with a counter
each: blocks over (image, column chunk) write the pairs' partial distances,
a block per image sums them in a fixed order, and the backward writes each
chunk of every gradient row from the pair weights.

On CPU tensors the same Function runs the route's plain versions:
:func:`energy_terms_reference` and :func:`energy_terms_bwd_reference` (K3,
and the jnp path), :func:`energy_terms_stream_reference` and
:func:`energy_terms_stream_bwd_reference` (K9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel
from .losses import STAB_EPS, _interaction_mean_chunked, generalized_energy_terms, pow_beta

__all__ = [
    "fused_energy_terms",
    "energy_terms",
    "energy_terms_bwd",
    "energy_terms_reference",
    "energy_terms_bwd_reference",
    "energy_terms_stream_reference",
    "energy_terms_stream_bwd_reference",
    "energy_route",
    "jax_kernel_gate",
    "jax_stream_gate",
    "FWD_LAUNCHES",
    "BWD_LAUNCHES",
    "STREAM_FWD_LAUNCHES",
    "STREAM_BWD_LAUNCHES",
    "M_MAX",
    "STREAM_M_MAX",
]

FWD_LAUNCHES = LaunchCounter("K3f")
BWD_LAUNCHES = LaunchCounter("K3b")
STREAM_FWD_LAUNCHES = LaunchCounter("K9f")
STREAM_BWD_LAUNCHES = LaunchCounter("K9b")
M_MAX = 16
STREAM_M_MAX = 64
_CHUNK_SMEM = 96 * 1024  # a block's rows and pair weights, two blocks per SM


def _dpow_beta(d2: torch.Tensor, beta: float) -> torch.Tensor:
    """d/d(d2) of the powered distance."""
    if beta == 2.0:
        return torch.ones_like(d2)
    return (beta / 2.0) * torch.pow(d2 + STAB_EPS, beta / 2.0 - 1.0)


def energy_terms_reference(x0hats: torch.Tensor, x0: torch.Tensor,
                           beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3f: ``(conf, inter)`` in fp32."""
    return generalized_energy_terms(x0hats.float(), x0.float(), beta)


def energy_terms_bwd_reference(x0hats, x0, beta: float, gconf, ginter):
    """Plain version of K3b, the gradient formula of ``_bwd_kernel``:

    ``dxh_i = 2 gc dpow(d2_i0) (x_i - x0) + 4 gi sum_{j != i} dpow(d2_ij) (x_i - x_j)``,
    ``dx0 = -sum_i 2 gc dpow(d2_i0) (x_i - x0)``,

    with ``gc = gconf / (B m)`` and ``gi = ginter / (B m (m - 1))``; one
    anchor row at a time, so memory stays O(B m D)."""
    B, m, _ = x0hats.shape
    xh, t = x0hats.float(), x0.float()
    gc = gconf.float() / (B * m)
    gi = ginter.float() / (B * m * (m - 1))
    diff0 = xh - t[:, None, :]
    g0 = (2.0 * gc) * _dpow_beta((diff0 * diff0).sum(-1, keepdim=True), beta) * diff0
    dxh = g0.clone()
    for i in range(m):
        diff = xh[:, i:i + 1, :] - xh  # x_i - x_j
        w = _dpow_beta((diff * diff).sum(-1, keepdim=True), beta)
        w[:, i] = 0.0
        dxh[:, i] += (4.0 * gi) * (w * diff).sum(1)
    return dxh, -g0.sum(1)


def energy_terms_stream_reference(x0hats: torch.Tensor, x0: torch.Tensor,
                                  beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9f, ``_fwd_kernel_stream``: the confinement over
    all rows, the interaction one anchor row at a time, each unordered pair
    visited twice; fp32, O(B m D) memory."""
    B, m, _ = x0hats.shape
    xh = x0hats.float()
    diff0 = xh - x0.float()[:, None, :]
    return pow_beta((diff0 * diff0).sum(-1), beta).mean(), _interaction_mean_chunked(xh, beta)


def energy_terms_stream_bwd_reference(x0hats, x0, beta: float, gconf, ginter):
    """Plain version of K9b, ``_bwd_kernel_stream``: dxh seeded with the
    confinement gradient, then each anchor's complete row
    ``4 gi sum_{j != i} dpow(d2_ij) (x_i - x_j)`` added. That is the anchor
    walk :func:`energy_terms_bwd_reference` already takes."""
    return energy_terms_bwd_reference(x0hats, x0, beta, gconf, ginter)


def jax_kernel_gate(B: int, m: int, D: int) -> bool:
    """The JAX package's gate for its K3 kernel, ``_kernel_supported``
    (ddm_tpu/ops/energy.py:74-85) as written: an image block ``bb`` of 8, 4,
    2 or 1 dividing B that is a multiple of 8 or all of B, its (bb, m, D)
    fp32 block within 4 MB of VMEM, 2 <= m <= 16, D a multiple of 128."""
    bb = 8
    while B % bb != 0 and bb > 1:
        bb //= 2
    return ((bb % 8 == 0 or bb == B) and bb * m * D * 4 <= 4 * 1024 * 1024
            and 2 <= m <= M_MAX and D % 128 == 0)


def jax_stream_gate(B: int, m: int, D: int) -> bool:
    """The JAX package's gate for its K9 kernel, ``_stream_supported``
    (ddm_tpu/ops/energy.py:233-241) as written: 16 < m <= 64, m a multiple
    of 8, D a multiple of 128, 8 (m, D) fp32 blocks within 14 MB of VMEM."""
    return (M_MAX < m <= STREAM_M_MAX and D % 128 == 0 and m % 8 == 0
            and 8 * m * D * 4 <= 14 * 1024 * 1024)


def energy_route(B: int, m: int, D: int) -> Optional[str]:
    """``"K3"``, ``"K9"`` or None (the jnp path), as ``fused_energy_terms``
    dispatches (ddm_tpu/ops/energy.py:384-391)."""
    if jax_kernel_gate(B, m, D):
        return "K3"
    if jax_stream_gate(B, m, D):
        return "K9"
    return None


def _route(x0hats: torch.Tensor, x0: torch.Tensor) -> Optional[str]:
    """The route of these shapes (any device)."""
    if x0hats.dim() != 3 or x0.shape != (x0hats.shape[0], x0hats.shape[2]):
        raise ValueError(f"the energy score takes (B, m, D) predictions and (B, D) targets, "
                         f"got {tuple(x0hats.shape)} and {tuple(x0.shape)}")
    if x0hats.shape[1] < 2:
        raise ValueError("m must be >= 2 to form interaction pairs")
    return energy_route(*x0hats.shape)


def _chunk(m: int, D: int) -> int:
    """The column chunk: the widest of 512, 256, 128 dividing D whose
    (m + 1) rows and m x m pair weights fit two blocks per SM."""
    for L in (512, 256, 128):
        if D % L == 0 and ((m + 1) * L + m * m + m) * 4 <= _CHUNK_SMEM:
            return L
    raise ValueError(f"the energy kernels take D a multiple of 128 and m <= "
                     f"{STREAM_M_MAX}, got m={m}, D={D}")


def _counters(route: str):
    return ((FWD_LAUNCHES, BWD_LAUNCHES) if route == "K3" else
            (STREAM_FWD_LAUNCHES, STREAM_BWD_LAUNCHES))


def _scratch(x0hats):
    B, m, D = x0hats.shape
    L = _chunk(m, D)
    part = torch.empty((B, D // L, m + m * (m - 1) // 2), dtype=torch.float32,
                       device=x0hats.device)
    return L, part


def energy_terms(x0hats: torch.Tensor, x0: torch.Tensor,
                 beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(conf, inter)`` of fp32 ``(B, m, D)`` predictions and ``(B, D)``
    targets: K3f or K9f on CUDA tensors by :func:`energy_route`; the route's
    plain version on CPU tensors, and on any device where the route is the
    jnp path."""
    route = _route(x0hats, x0)
    if route is None or not uses_kernel(x0hats, x0):
        plain = energy_terms_stream_reference if route == "K9" else energy_terms_reference
        return plain(x0hats, x0, beta)
    B, m, D = x0hats.shape
    partial = torch.empty((B, 2), dtype=torch.float32, device=x0hats.device)
    out = torch.empty((2,), dtype=torch.float32, device=x0hats.device)
    L, part = _scratch(x0hats)
    check_status(load_library().ddm_energy_fwd(
        x0hats.data_ptr(), x0.data_ptr(), part.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, m, D, L, beta, current_stream(x0hats.device)), f"{route}f energy_fwd")
    _counters(route)[0].add()
    return out[0].clone(), out[1].clone()


def energy_terms_bwd(x0hats, x0, beta: float, gconf, ginter):
    """``(dx0hats, dx0)`` for the cotangents of ``(conf, inter)``: K3b or K9b
    on CUDA tensors by :func:`energy_route`; the route's plain version on CPU
    tensors, and on any device where the route is the jnp path."""
    route = _route(x0hats, x0)
    if route is None or not uses_kernel(x0hats, x0, gconf, ginter):
        plain = (energy_terms_stream_bwd_reference if route == "K9" else
                 energy_terms_bwd_reference)
        return plain(x0hats, x0, beta, gconf, ginter)
    B, m, D = x0hats.shape
    g = torch.stack([gconf / (B * m), ginter / (B * m * (m - 1))]).float().contiguous()
    dxh = torch.empty_like(x0hats)
    dx0 = torch.empty_like(x0)
    L, part = _scratch(x0hats)
    coef = torch.empty((B, part.shape[2]), dtype=torch.float32, device=x0hats.device)
    check_status(load_library().ddm_energy_bwd(
        x0hats.data_ptr(), x0.data_ptr(), g.data_ptr(), part.data_ptr(), coef.data_ptr(),
        dxh.data_ptr(), dx0.data_ptr(), B, m, D, L, beta, current_stream(x0hats.device)),
        f"{route}b energy_bwd")
    _counters(route)[1].add()
    return dxh, dx0


class _EnergyTerms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0hats, x0, beta):
        ctx.save_for_backward(x0hats, x0)
        ctx.beta = beta
        return energy_terms(x0hats, x0, beta)

    @staticmethod
    def backward(ctx, gconf, ginter):
        x0hats, x0 = ctx.saved_tensors
        return (*energy_terms_bwd(x0hats, x0, ctx.beta, gconf, ginter), None)


def fused_energy_terms(x0hats: torch.Tensor, x0: torch.Tensor,
                       beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy-score terms ``(conf, inter)`` of fp32 predictions ``(B, m, D)``
    and targets ``(B, D)``, differentiable in both.

    CPU tensors take the plain versions; CUDA tensors launch K3f/K3b or
    K9f/K9b where the JAX package's gates send it to a kernel, and take the
    plain versions on the device where they send it to its jnp path."""
    return _EnergyTerms.apply(x0hats.float().contiguous(), x0.float().contiguous(),
                              float(beta))
