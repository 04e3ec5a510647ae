"""The JAX package's kernel tier ladder as pure shape functions.

The JAX half-blocks pick a kernel tier from their shapes against the TPU's
VMEM budgets. The port runs the same tier on the same shapes, so that both
packages take one path (as :func:`ddm_tpu_torch.ops.energy.jax_kernel_gate`
does for the energy score). These are the port's own copies, with the
default budgets only (the TPU-only hatches ``DDM_TPU_ATTN_BWD_BI``,
``DDM_TPU_MLP_VMEM_MB`` and ``DDM_TPU_MLP_ROW_BLOCK`` are not ported), and
with ``kernels_enabled()`` taken as true, of:

- ``ddm_tpu/ops/attention.py``: ``_choose_blocks``, ``_attn_pack``,
  ``_fwd_block_images``, ``_bwd_split_block_images``, ``_bwd_block_images``
  and the ``shapes_ok`` test of ``fused_attention_block``;
- ``ddm_tpu/ops/mlp_block.py``: ``_vmem_mb``, ``_bwd_budget``,
  ``_fwd_budget``, ``_row_block``, ``_fwd_fixed``, ``_mlp_kernel_ok``,
  ``_mlp_fwd_kernel_ok`` and ``_mlp_fwd_fchunks``;
- ``ddm_tpu/ops/expert_ffn.py``: ``expert_ffn_ok``, ``_expert_fwd_fchunks``
  and ``expert_ffn_fwd_ok``.

The three choosers return ``None`` where the JAX ladder falls through to
its jnp/XLA reference. There the MLP half-block and the expert FFN run no
kernel in the JAX package, and the port runs their plain versions, on CUDA
tensors too. The attention half-block's fallback can still reach a kernel
(the standalone attention core K7, ``fused_attention``), which the port
lacks: CUDA tensors raise there (:func:`no_kernel`). A CPU test holds every
function here equal to its JAX original.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["attention_tier", "mlp_tier", "expert_tier", "no_kernel"]

_MB = 1024 * 1024
_VMEM_MB = 16  # DDM_TPU_MLP_VMEM_MB's default: Mosaic's scoped-vmem line


# --- attention half-block (ddm_tpu/ops/attention.py) ---

def _choose_blocks(B: int, N: int, D: int, dtype_bytes: int = 2) -> Tuple[int, int]:
    """``(bi images per grid step, g images packed per matmul)``."""
    g = max(1, min(256 // N, 8))
    g = 1 << (g.bit_length() - 1)
    while B % g != 0:
        g //= 2
    bi = g
    while bi * 2 <= 64 and B % (bi * 2) == 0 and 4 * (bi * 2) * N * D * dtype_bytes < 6 * _MB:
        bi *= 2
    return bi, g


def _fwd_block_images(B: int, N: int, D: int, g: int) -> int:
    bi, _ = _choose_blocks(B, N, D)
    bi = min(bi, 16 if D <= 512 else 4)
    fixed = (D * 3 * D + D * D) * 2 + (g * N) ** 2 * 4
    per_bi = 30 * N * D
    while bi >= max(g, 1):
        if B % bi == 0 and bi % g == 0 and fixed + bi * per_bi < 15 * _MB:
            return bi
        bi //= 2
    return 0


def _bwd_split_block_images(B: int, N: int, D: int, g: int, H: int) -> int:
    fixed = (D * 3 * D + D * D) * 2 + (g * N) ** 2 * 4
    per_bi = 30 * N * D
    bi = 8
    while bi >= max(g, 1):
        stack = (bi // g) * H * (g * N) ** 2 * 4
        if B % bi == 0 and bi % g == 0 and fixed + bi * per_bi + stack < 15500 * 1024:
            return bi
        bi //= 2
    return 0


def _bwd_block_images(B: int, N: int, D: int, g: int, H: int) -> int:
    fixed = (D * 3 * D + D * D) * (2 + 4) + (g * N) ** 2 * 4
    per_bi = 30 * N * D
    bi = 8
    while bi >= max(g, 1):
        stacks = 2 * (bi // g) * H * (g * N) ** 2 * 4
        if B % bi == 0 and bi % g == 0 and fixed + bi * per_bi + stacks < 16 * _MB:
            return bi
        bi //= 2
    return 0


def _attn_pack(B: int, N: int, D: int, H: int) -> int:
    _, g = _choose_blocks(B, N, D)
    while g >= 1:
        if _fwd_block_images(B, N, D, g) >= g and (
                _bwd_block_images(B, N, D, g, H) >= g
                or _bwd_split_block_images(B, N, D, g, H) >= g):
            return g
        g //= 2
    return 0


def attention_tier(B: int, N: int, D: int, H: int) -> Optional[str]:
    """The JAX attention half-block's tier for (B, N, D) tokens of H heads:
    ``"fused"`` (K2f + the fused backward K2b), ``"split"`` (K2f + the split
    backward K4), or None (the JAX package's XLA half-block)."""
    g = _attn_pack(B, N, D, H)
    shapes_ok = (g >= 1 and N % 8 == 0 and N <= 512 and (D // H) % 8 == 0
                 and D % 128 == 0 and B % g == 0)
    if shapes_ok and _bwd_block_images(B, N, D, g, H) >= g:
        return "fused"
    if shapes_ok and _bwd_split_block_images(B, N, D, g, H) >= g:
        return "split"
    return None


# --- dense MLP half-block (ddm_tpu/ops/mlp_block.py) ---

def _bwd_budget() -> int:
    return (_VMEM_MB - 4) * _MB


def _fwd_budget() -> int:
    return (_VMEM_MB - 1) * _MB


def _row_block(T: int, D: int, F: int, fixed: Optional[int] = None) -> int:
    rb = 1024
    while T % rb != 0 and rb > 8:
        rb //= 2
    if fixed is None:
        budget, fixed = _bwd_budget(), 12 * D * F
    else:
        budget = _fwd_budget()
    while rb > 8 and fixed + rb * (D * 8 + F * 8) > budget:
        rb //= 2
    return rb


def _fwd_fixed(D: int, F: int) -> int:
    return 4 * D * F


def _mlp_kernel_ok(T: int, D: int, F: int) -> bool:
    rb = _row_block(T, D, F)
    return (D % 128 == 0 and F % 128 == 0 and T % rb == 0 and rb >= 64
            and 12 * D * F + rb * (D * 8 + F * 8) < _bwd_budget() + 3 * _MB)


def _mlp_fwd_kernel_ok(T: int, D: int, F: int) -> bool:
    rb = _row_block(T, D, F, fixed=_fwd_fixed(D, F))
    return (D % 128 == 0 and F % 128 == 0 and T % rb == 0
            and _fwd_fixed(D, F) + rb * (D * 8 + F * 8) < _fwd_budget())


def _mlp_fwd_fchunks(T: int, D: int, F: int) -> int:
    k = 1
    while k <= 8:
        if F % (k * 128) == 0 and _mlp_fwd_kernel_ok(T, D, F // k):
            return k
        k *= 2
    return 0


def mlp_tier(T: int, D: int, F: int) -> Optional[Tuple[str, int]]:
    """The JAX MLP half-block's tier for (T, D) rows of hidden width F:
    ``("fused", 1)`` (K1f + K1b), ``("fwdonly", 1)`` (K1f, then XLA's
    backward), ``("fchunked", k)`` (k partial forwards K6f, then XLA's
    backward), or None (the JAX package's jnp reference)."""
    if _mlp_kernel_ok(T, D, F):
        return ("fused", 1)
    if _mlp_fwd_kernel_ok(T, D, F):
        return ("fwdonly", 1)
    if D % 128 == 0:
        k = _mlp_fwd_fchunks(T, D, F)
        if k > 1:
            return ("fchunked", k)
    return None


# --- expert FFN (ddm_tpu/ops/expert_ffn.py) ---

def _expert_ffn_ok(E: int, S: int, D: int, F: int) -> bool:
    rb = _row_block(S, D, F)
    return (D % 128 == 0 and F % 128 == 0 and S % rb == 0 and rb >= 64
            and 12 * D * F + rb * (D * 8 + F * 8) < 15 * _MB)


def _expert_fwd_fchunks(S: int, D: int, F: int) -> int:
    k = 1
    while k <= 8:
        fc = F // k
        if F % (k * 128) == 0:
            rb = _row_block(S, D, fc, fixed=8 * D * fc)
            if S % rb == 0 and 8 * D * fc + rb * (D * 8 + fc * 8) < 15 * _MB:
                return k
        k *= 2
    return 0


def _expert_ffn_fwd_ok(E: int, S: int, D: int, F: int) -> bool:
    return D % 128 == 0 and F % 128 == 0 and _expert_fwd_fchunks(S, D, F) > 0


def expert_tier(E: int, S: int, D: int, F: int) -> Optional[Tuple[str, int]]:
    """The JAX expert FFN's tier (``expert_ffn_auto``) for (E, S, D) slot
    rows of hidden width F: ``("fused", 1)`` (K10f + K10b),
    ``("fwdonly", k)`` (K10f at k = 1, else k partial forwards K10p; then
    XLA's backward), or None (the JAX package's jnp reference)."""
    if _expert_ffn_ok(E, S, D, F):
        return ("fused", 1)
    if _expert_ffn_fwd_ok(E, S, D, F):
        return ("fwdonly", _expert_fwd_fchunks(S, D, F))
    return None


def no_kernel(what: str, shape: str) -> NotImplementedError:
    """The error a CUDA tensor raises where the JAX attention ladder has no
    half-block tier: the JAX package runs its XLA half-block around
    ``fused_attention``, whose kernel K7 the port lacks."""
    return NotImplementedError(
        f"{what} at {shape}: the JAX tier ladder has no half-block kernel for these shapes and "
        "runs its XLA half-block around the standalone attention core K7 (ddm_tpu/ops/"
        "attention.py fused_attention, where that kernel's gate holds), which the port does "
        "not have yet: ROADMAP.md Queue 1 items 9 and 11 (K7)")
