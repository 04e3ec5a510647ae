"""The phase-batched attention half-block (X1), an experiment.

Port of ``tools/exp_phase_softmax.py``: ``phase_fwd_call``
(``_blk_fwd_kernel_phase``), ``phase_bwd_call`` (``_blk_bwd_kernel_phase``)
and ``persist_bwd_call`` (``_blk_bwd_kernel_persist``). The TPU bodies run
the attention half-block with each pack's heads done in coarse phases: all
H Q K^T products into one stacked fp32 scratch, one softmax over the stack,
then all H P V products (and, backward, dv and dP for every head, one
stacked dS pass, then dq and dk). The JAX package kept its per-head
kernels, and so does the port: nothing in ``models/`` calls this module;
``scripts/torch_exp_phase_softmax.py`` times it against the production
cores.

On CUDA tensors :func:`phase_attention_block_fwd` is K2f's chain
(``ops/attention.py`` ``_fwd_chain``) around X1f, and
:func:`phase_attention_block_bwd` K2b's chain (``_bwd_chain``) around X1b
(``csrc/phase_softmax.cu``). X1f takes one image's query tile over all H
heads, X1b one image's group of G heads; each head's products are the
production cores' tiles in the same order, so their outputs are the
production K2f's and K2b's bit for bit. On CPU tensors they run the
production plain versions, :func:`~ddm_tpu_torch.ops.attention.attention_block_reference`
and :func:`~ddm_tpu_torch.ops.attention.attention_block_bwd_reference`: the
function is the same. ``persist_bwd_call``'s body is the production
``_blk_bwd_kernel`` line for line, so its counterpart is the port's K2b
(:func:`~ddm_tpu_torch.ops.attention.attention_block_bwd`), and this module
adds no kernel for it.

The stack is held in shared memory: at N = Dh = 64, X1f's H x QT score and
probability rows (94 KB at DiT-S/4's H 6 and QT 32, 174 KB at DiT-B/4's H
12) and X1b's 44 KB a head, so a backward group holds at most 4 heads and
DiT-S/4's 6 run as groups of 1, 2 or 3 (the library's plan,
:func:`library_plan`). The shapes are :func:`phase_softmax_takes`'s, on
either device; others raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from . import attention as A
from . import flash
from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel

__all__ = [
    "phase_attention_block_fwd",
    "phase_attention_block_bwd",
    "phase_softmax_takes",
    "library_plan",
    "launch_x1f",
    "launch_x1b",
    "LAUNCHES",
    "BWD_LAUNCHES",
]

LAUNCHES = LaunchCounter("X1f")
BWD_LAUNCHES = LaunchCounter("X1b")
# csrc/phase_softmax.cu's bounds (its static_asserts: the widest layouts fit)
MAX_TOKENS, MAX_HEAD, MAX_HEADS = 64, 64, 12


def phase_softmax_takes(B: int, N: int, D: int, H: int) -> bool:
    """Whether X1 takes the shape: whole images of 16 <= N <= 64 tokens (N %
    16 == 0), at most 12 heads of Dh = D / H a multiple of 8 up to 64, D a
    multiple of 64 (the half-block GEMMs'): DiT-S/4 (D 384, H 6) and DiT-B/4
    (D 768, H 12) at N 64, training and sampling batches."""
    if B < 1 or not 1 <= H <= MAX_HEADS or D % H or N % 16 or not 16 <= N <= MAX_TOKENS:
        return False
    Dh = D // H
    return Dh % 8 == 0 and Dh <= MAX_HEAD and D % 64 == 0


def _refuse(x, H: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"X1 takes (B, N, D) tokens, got shape {tuple(x.shape)}")
    B, N, D = x.shape
    if not phase_softmax_takes(B, N, D, H):
        raise NotImplementedError(
            f"X1, the phase-batched attention experiment, takes 16 <= N <= {MAX_TOKENS} tokens "
            f"(N % 16 == 0), at most {MAX_HEADS} heads of Dh % 8 == 0 up to {MAX_HEAD} and D % "
            f"64 == 0 (DiT-S/4's and DiT-B/4's widths at N 64); got (B={B}, N={N}, D={D}, "
            f"H={H}). Other shapes are ROADMAP.md item 14's")


def library_plan(N: int, D: int, H: int) -> dict:
    """X1's tiles at N tokens of width D over H heads, from the card's
    library (it builds the kernels): X1f's query tile ``QT``, the most heads
    a backward group holds (``most``), X1b's group ``G`` (the largest
    dividing H), every group that fits and divides H (``groups``), and each
    kernel's shared-memory bytes."""
    p = (ctypes.c_int * 5)()
    check_status(load_library().ddm_attention_phase_plan(N, D // H, H, ctypes.addressof(p)),
                 f"X1 plan at N={N}, D={D}, H={H}")
    groups = [g for g in range(1, min(p[1], H) + 1) if H % g == 0]
    return {"QT": p[0], "most": p[1], "G": p[2], "groups": groups, "fwd_smem": p[3],
            "bwd_smem": p[4]}


def launch_x1f(q, k, v, H: int) -> torch.Tensor:
    """X1f on CUDA tensors its caller has checked: the (B, N, D) bf16
    attention output, q, k and v read in place where they share one row
    stride (the thirds of a qkv buffer)."""
    q, k, v, ld = flash._qkv_rows(q, k, v)
    B, N, D = q.shape
    out = torch.empty((B, N, D), dtype=torch.bfloat16, device=q.device)
    check_status(load_library().ddm_phase_attention_core(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, out.data_ptr(), B, N, H, D // H,
        (D // H) ** -0.5, current_stream(q.device)), "X1f phase_attention_core")
    LAUNCHES.add()
    return out


def launch_x1b(q, k, v, do, H: int, G=None):
    """X1b on CUDA tensors its caller has checked, at groups of ``G`` heads
    (None: :func:`library_plan`'s; the library refuses a G that does not
    divide H or fit) -> ``(att (B, N, D), dqkv (B, N, 3D))``, bf16."""
    q, k, v, ld = flash._qkv_rows(q, k, v)
    B, N, D = q.shape
    if do.shape != q.shape:
        raise ValueError(f"X1b takes do of shape {tuple(q.shape)}, got {tuple(do.shape)}")
    if G is None:
        G = library_plan(N, D, H)["G"]
    do = flash._aligned(do.to(torch.bfloat16))
    att = torch.empty((B, N, D), dtype=torch.bfloat16, device=q.device)
    dqkv = torch.empty((B, N, 3 * D), dtype=torch.bfloat16, device=q.device)
    check_status(load_library().ddm_phase_attention_core_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, do.data_ptr(), att.data_ptr(),
        dqkv.data_ptr(), B, N, H, D // H, (D // H) ** -0.5, G, current_stream(q.device)),
        f"X1b phase_attention_core_bwd at G={G}")
    BWD_LAUNCHES.add()
    return att, dqkv


def phase_attention_block_fwd(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int):
    """``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens, forward only:
    K2f's chain around X1f on CUDA tensors (bf16 activations, fp32 LN
    parameters and biases, weights cast to bf16), K2f's output bit for bit;
    :func:`~ddm_tpu_torch.ops.attention.attention_block_reference` on CPU
    tensors. Shapes outside :func:`phase_softmax_takes` raise on either
    device."""
    args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    _refuse(x, H)
    if not uses_kernel(*args):
        return A.attention_block_reference(*args, H)
    A._check(*args, H)
    D = x.shape[-1]
    out, _, _ = A._fwd_chain(*args, lambda qkv: (launch_x1f(*qkv.split(D, dim=-1), H), None))
    return out


def phase_attention_block_bwd(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, dout,
                              G=None):
    """The gradients of the half-block with respect to ``(x, scale, bias,
    wqkv, bqkv, wproj, bproj)`` for the cotangent ``dout``: K2b's chain
    around X1b at groups of ``G`` heads (None: the library's plan) on CUDA
    tensors, K2b's gradients bit for bit;
    :func:`~ddm_tpu_torch.ops.attention.attention_block_bwd_reference` on
    CPU tensors."""
    args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    _refuse(x, H)
    if not uses_kernel(*args, dout):
        return A.attention_block_bwd_reference(*args, H, dout)
    A._check(*args, H)
    D = x.shape[-1]
    return A._bwd_chain(*args, dout, lambda qkv, datt: launch_x1b(
        *qkv.split(D, dim=-1), datt, H, G))
