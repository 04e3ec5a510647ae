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
  and the ``shapes_ok`` test of ``fused_attention_block``; the standalone
  core's ``_core_bwd_block_images`` and the gate of ``fused_attention``;
- ``ddm_tpu/ops/flash.py``: ``_heads_per_group``, the VMEM estimators and
  tile pickers (``_pick``, ``_tile_sizes``, ``_pick_windowed``) and
  ``flash_supported``;
- ``ddm_tpu/ops/mlp_block.py``: ``_vmem_mb``, ``_bwd_budget``,
  ``_fwd_budget``, ``_row_block``, ``_fwd_fixed``, ``_mlp_kernel_ok``,
  ``_mlp_fwd_kernel_ok`` and ``_mlp_fwd_fchunks``;
- ``ddm_tpu/ops/expert_ffn.py``: ``expert_ffn_ok``, ``_expert_fwd_fchunks``
  and ``expert_ffn_fwd_ok``.

The tensor-parallel MLP partial (``fused_mlp_partial``) takes
:func:`mlp_tier` without its F-chunked tier, as JAX's does: at ``fused``
its forward is K6f and its backward K6b, as on the TPU; at ``fwdonly`` JAX
runs K6f and then XLA's backward, and the port runs K6b there (as it runs
K1b after the wide tiers' forwards); elsewhere both packages run the plain
partial.

The three half-block choosers return ``None`` where the JAX ladder falls
through to its jnp/XLA reference. There the MLP half-block and the expert
FFN run no kernel in the JAX package, and the port runs their plain
versions, on CUDA tensors too. The attention half-block's fallback, the
ladder's third rung, is an XLA half-block around ``fused_attention``, whose
core :func:`core_tier` picks: the standalone core K7, the long-sequence
core K8, or (``None``) XLA's plain attention, which the port runs as its
plain core. A CPU test holds every function here equal to its JAX original.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["attention_tier", "core_tier", "mlp_tier", "expert_tier"]

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


# --- the third rung's attention core (ddm_tpu/ops/attention.py, flash.py) ---

def _core_bwd_block_images(B: int, N: int, D: int, g: int) -> int:
    bi, _ = _choose_blocks(B, N, D)
    while bi >= max(g, 1):
        est = 2 * 8 * bi * N * D * 2 + 3 * (g * N) ** 2 * 4
        if B % bi == 0 and bi % g == 0 and est < 15 * _MB:
            return bi
        bi //= 2
    return 0


def _k7_gate(B: int, N: int, D: int, H: int) -> bool:
    """``fused_attention``'s test for its packed kernel K7."""
    Dh = D // H
    bi, g = _choose_blocks(B, N, D)
    return (N % 8 == 0 and N <= 512 and Dh % 8 == 0 and D % 128 == 0 and B % bi == 0
            and _core_bwd_block_images(B, N, D, g) >= max(g, 1))


_LANES = 128
_FLASH_BUDGET = int(14.5 * _MB)


def _heads_per_group(Dh: int) -> int:
    if Dh >= _LANES:
        return 1 if Dh % _LANES == 0 else 0
    return _LANES // Dh if _LANES % Dh == 0 else 0


def _fwd_bytes(N: int, W: int, hp: int, cq: int, bq: int, bk: int) -> int:
    kv = 2 * 2 * N * W * 2
    qo = 2 * 2 * cq * W * 2 + 2 * cq * hp * 4
    return kv + qo + 2 * hp * bq * bk * 4 + hp * bq * W * 4


def _bwd_bytes(N: int, W: int, hp: int, cq: int, bq: int, bk: int) -> int:
    kv = 2 * 2 * N * W * 2 + 2 * 2 * N * W * 2
    qblk = 4 * 2 * cq * W * 2 + 2 * cq * hp * 4
    scratch = 2 * N * W * 4
    tiles = 4 * hp * bq * bk * 4 + 3 * hp * bq * W * 4
    return kv + qblk + scratch + tiles


def _pick(N: int, W: int, hp: int, estimate) -> Tuple[int, int, int]:
    for bq_options in ((512, 256, 128), (64,)):
        for cq in (N, 2048, 1024, 512):
            if cq > N or N % cq:
                continue
            for bk in (N, 1024, 512, 256):
                if bk > N or N % bk:
                    continue
                for bq in bq_options:
                    if bq > cq or cq % bq:
                        continue
                    if estimate(N, W, hp, cq, bq, bk) < _FLASH_BUDGET:
                        return cq, bq, bk
    return 0, 0, 0


def _tile_sizes(N: int, Dh: int):
    hp = _heads_per_group(Dh)
    if hp == 0:
        return (0, 0, 0), (0, 0, 0)
    W = hp * Dh
    return _pick(N, W, hp, _fwd_bytes), _pick(N, W, hp, _bwd_bytes)


def _fwd_win_bytes(W: int, hp: int, cq: int, ck: int, bq: int, bk: int) -> int:
    kv = 2 * 2 * ck * W * 2
    qo = 2 * 2 * cq * W * 2 + 2 * cq * hp * 4
    scr = hp * cq * W * 4 + 2 * hp * cq * _LANES * 4
    tiles = 2 * hp * bq * bk * 4 + hp * bq * W * 4
    return kv + qo + scr + tiles


def _bwd_dq_bytes(W: int, hp: int, cq: int, ck: int, bq: int, bk: int) -> int:
    kv = 2 * 2 * ck * W * 2
    qblk = 4 * 2 * cq * W * 2 + 2 * cq * hp * 4
    scr = cq * W * 4
    tiles = 4 * hp * bq * bk * 4 + 3 * hp * bq * W * 4
    return kv + qblk + scr + tiles


def _bwd_dkv_bytes(W: int, hp: int, cq: int, ck: int, bq: int, bk: int) -> int:
    kv = 2 * 2 * ck * W * 2 + 2 * 2 * ck * W * 2
    qblk = 3 * 2 * cq * W * 2 + 2 * cq * hp * 4
    scr = 2 * ck * W * 4
    tiles = 4 * hp * bq * bk * 4 + 3 * hp * bq * W * 4
    return kv + qblk + scr + tiles


def _pick_windowed(N: int, W: int, hp: int, estimates) -> Tuple[int, int, int, int]:
    for ck in (2048, 1024, 512):
        if ck > N or N % ck:
            continue
        for cq in (1024, 512, 256):
            if cq > N or N % cq:
                continue
            for bk in (1024, 512, 256):
                if bk > ck or ck % bk:
                    continue
                for bq in (256, 128, 64):
                    if bq > cq or cq % bq:
                        continue
                    if all(e(W, hp, cq, ck, bq, bk) < _FLASH_BUDGET for e in estimates):
                        return cq, ck, bq, bk
    return 0, 0, 0, 0


def _windowed_fwd_tiles(N: int, Dh: int) -> Tuple[int, int, int, int]:
    hp = _heads_per_group(Dh)
    if hp == 0:
        return 0, 0, 0, 0
    return _pick_windowed(N, hp * Dh, hp, (_fwd_win_bytes,))


def _windowed_bwd_tiles(N: int, Dh: int) -> Tuple[int, int, int, int]:
    hp = _heads_per_group(Dh)
    if hp == 0:
        return 0, 0, 0, 0
    return _pick_windowed(N, hp * Dh, hp, (_bwd_dq_bytes, _bwd_dkv_bytes))


def _k8_gate(B: int, N: int, D: int, H: int) -> bool:
    """JAX's ``flash_supported``: N >= 1024, a whole head group or a phantom
    pad of at most H heads, and a single-pass or windowed tiling each way."""
    if H <= 0 or D % H:
        return False
    Dh = D // H
    hp = _heads_per_group(Dh)
    if hp == 0:
        return False
    f, b = _tile_sizes(N, Dh)
    fwd_ok = f[0] > 0 or _windowed_fwd_tiles(N, Dh)[0] > 0
    bwd_ok = b[0] > 0 or _windowed_bwd_tiles(N, Dh)[0] > 0
    return N >= 1024 and (-H) % hp <= H and fwd_ok and bwd_ok


def core_tier(B: int, N: int, D: int, H: int) -> Optional[str]:
    """The attention core that JAX's ``fused_attention`` takes for (B, N, D)
    q, k and v of H heads, the core of the ladder's third rung: ``"K7"``
    (the packed standalone core), ``"K8"`` (the online-softmax core), or
    None (XLA's ``attention_reference``)."""
    if _k7_gate(B, N, D, H):
        return "K7"
    if _k8_gate(B, N, D, H):
        return "K8"
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
