"""Fused generalized energy-score terms with their gradient (kernel K3).

Port of ``ddm_tpu/ops/energy.py`` ``fused_energy_terms``. It is a
``torch.autograd.Function`` over fp32 predictions ``(B, m, D)`` and targets
``(B, D)`` that returns ``(conf, inter)`` with the contract of
:func:`ddm_tpu_torch.ops.losses.generalized_energy_terms`. On CUDA tensors
the forward launches K3f and the backward K3b (``csrc/energy.cu``): one
block per image holds its m predictions and its target in shared memory and
forms every distance from direct differences; the per-image sums are added
in a fixed order by a second kernel. On CPU tensors the same Function runs
the plain versions, :func:`energy_terms_reference` and
:func:`energy_terms_bwd_reference`.

The kernels take 2 <= m <= 16 (the TPU kernel's range). Past that the JAX
package streams anchor rows through a second kernel (K9); that kernel is not
ported yet, and a CUDA tensor with m > 16 raises. Where the JAX package's
own gate for K3 (:func:`jax_kernel_gate`, its VMEM bound) sends a shape to
its jnp path, the port runs its plain version on the device too: at
``--image-size 128`` (B = 16, m = 8, D = 49,152) that is the path both take.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel
from .losses import STAB_EPS, generalized_energy_terms

__all__ = [
    "fused_energy_terms",
    "energy_terms",
    "energy_terms_bwd",
    "energy_terms_reference",
    "energy_terms_bwd_reference",
    "jax_kernel_gate",
    "FWD_LAUNCHES",
    "BWD_LAUNCHES",
    "M_MAX",
]

FWD_LAUNCHES = LaunchCounter("K3f")
BWD_LAUNCHES = LaunchCounter("K3b")
M_MAX = 16
_MAX_SMEM = 232448
_STATIC_SMEM = 2 * (M_MAX + M_MAX * (M_MAX - 1) // 2) * 4  # the d2 and coef arrays


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


def _use_kernel(x0hats: torch.Tensor, x0: torch.Tensor, *others: torch.Tensor) -> bool:
    """True to launch K3; False for the plain version: on CPU tensors, and on
    CUDA tensors of a shape whose JAX counterpart takes its jnp path."""
    if not uses_kernel(x0hats, x0, *others):
        return False
    if x0hats.dim() != 3 or x0.shape != (x0hats.shape[0], x0hats.shape[2]):
        raise ValueError(f"K3 takes (B, m, D) predictions and (B, D) targets, got "
                         f"{tuple(x0hats.shape)} and {tuple(x0.shape)}")
    B, m, D = x0hats.shape
    if m > M_MAX:
        raise NotImplementedError(
            f"K3 takes m <= {M_MAX}, got m={m}: the large-m energy kernel (K9) is not "
            "ported yet, see ROADMAP.md Queue 1 item 4")
    if m < 2:
        raise ValueError("m must be >= 2 to form interaction pairs")
    if not jax_kernel_gate(B, m, D):
        return False
    if D % 4 or (m + 1) * D * 4 + _STATIC_SMEM > _MAX_SMEM:
        raise ValueError(f"K3 needs D a multiple of 4 with (m + 1) * D fp32 values in "
                         f"shared memory, got m={m}, D={D}")
    return True


def energy_terms(x0hats: torch.Tensor, x0: torch.Tensor,
                 beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(conf, inter)`` of fp32 ``(B, m, D)`` predictions and ``(B, D)``
    targets: K3f on CUDA tensors (or raise), the plain version on CPU and
    where :func:`jax_kernel_gate` is False."""
    if not _use_kernel(x0hats, x0):
        return energy_terms_reference(x0hats, x0, beta)
    B, m, D = x0hats.shape
    partial = torch.empty((B, 2), dtype=torch.float32, device=x0hats.device)
    out = torch.empty((2,), dtype=torch.float32, device=x0hats.device)
    check_status(load_library().ddm_energy_fwd(
        x0hats.data_ptr(), x0.data_ptr(), partial.data_ptr(), out.data_ptr(), B, m, D,
        beta, current_stream(x0hats.device)), "K3f energy_fwd")
    FWD_LAUNCHES.add()
    return out[0].clone(), out[1].clone()


def energy_terms_bwd(x0hats, x0, beta: float, gconf, ginter):
    """``(dx0hats, dx0)`` for the cotangents of ``(conf, inter)``: K3b on
    CUDA tensors (or raise), :func:`energy_terms_bwd_reference` on CPU and
    where :func:`jax_kernel_gate` is False."""
    if not _use_kernel(x0hats, x0, gconf, ginter):
        return energy_terms_bwd_reference(x0hats, x0, beta, gconf, ginter)
    B, m, D = x0hats.shape
    g = torch.stack([gconf / (B * m), ginter / (B * m * (m - 1))]).float().contiguous()
    dxh = torch.empty_like(x0hats)
    dx0 = torch.empty_like(x0)
    check_status(load_library().ddm_energy_bwd(
        x0hats.data_ptr(), x0.data_ptr(), g.data_ptr(), dxh.data_ptr(), dx0.data_ptr(),
        B, m, D, beta, current_stream(x0hats.device)), "K3b energy_bwd")
    BWD_LAUNCHES.add()
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

    CPU tensors take the plain versions; CUDA tensors launch K3f/K3b or raise
    (m > 16 names the unported K9), or take the plain versions on the device
    where the JAX package's K3 gate sends it to its jnp path."""
    return _EnergyTerms.apply(x0hats.float().contiguous(), x0.float().contiguous(),
                              float(beta))
