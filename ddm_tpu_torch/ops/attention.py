"""Attention half-block ``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens.

Port of ``ddm_tpu/ops/attention.py`` (the half-block forward). On a CUDA
tensor :func:`fused_attention_block` launches kernel K2, three hand-written
CUDA kernels: an LN-prologue qkv GEMM (``csrc/gemm.cu``), the attention core
with one block per (image, head) (``csrc/attention.cu``), and the projection
GEMM with a ``x + (acc + bproj)`` epilogue (``csrc/gemm.cu``). On a CPU
tensor it runs :func:`attention_block_reference`, the plain version.

Layout: the fused qkv product emits ``[q | k | v]`` with heads contiguous in
each third, as the JAX package and the reference checkpoint order them.
Weights use ``nn.Linear``'s layout: ``wqkv`` is (3D, D), ``wproj`` (D, D).

Numerics (both versions): fp32 LN with eps 1e-6; qkv accumulated in fp32,
``+ bqkv``, rounded to the compute dtype; scores in fp32 with scale
Dh^-0.5; max-subtracted softmax in fp32; probabilities rounded to the
compute dtype; P V accumulated in fp32 and rounded; the projection
accumulated in fp32 and the residual added in fp32 before one rounding.
"""

from __future__ import annotations

import torch

from .kernel_config import (
    LaunchCounter,
    check_status,
    current_stream,
    load_library,
    uses_kernel,
)
from .mlp_block import layer_norm, matmul_f32

__all__ = [
    "attention_reference",
    "attention_block_reference",
    "fused_attention_block",
    "LAUNCHES",
    "MAX_TOKENS",
]

LAUNCHES = LaunchCounter()
MAX_TOKENS = 128  # K2's attention core holds one image's N x N scores in shared memory
_MAX_SMEM = 232448


def attention_reference(q, k, v, H: int, scale=None):
    """Plain multi-head attention on (B, N, H*Dh) inputs, heads contiguous."""
    B, N, D = q.shape
    Dh = D // H
    if scale is None:
        scale = Dh ** -0.5
    dtype = q.dtype
    z = lambda a: a.reshape(B, N, H, Dh).transpose(1, 2).float()  # noqa: E731
    s = torch.matmul(z(q), z(k).transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(dtype)
    o = torch.matmul(p.float(), z(v)).to(dtype)
    return o.transpose(1, 2).reshape(B, N, D)


def attention_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int):
    """Plain PyTorch version of K2 over (B, N, D) tokens in ``x.dtype``."""
    B, N, D = x.shape
    dtype = x.dtype
    xf = x.float()
    y = layer_norm(xf, scale_p, bias_p).to(dtype)
    qkv = (matmul_f32(y, wqkv, dtype) + bqkv.float()).to(dtype)
    q, k, v = qkv.split(D, dim=-1)
    o = attention_reference(q, k, v, H)
    out = matmul_f32(o, wproj, dtype) + bproj.float()
    return (xf + out).to(dtype)


def _core_smem(N: int, Dh: int) -> int:
    return 3 * N * (Dh + 8) * 2 + N * (max(N, Dh) + 4) * 4 + N * (N + 8) * 2


def supported_tokens(N: int, Dh: int) -> bool:
    """Whether K2's attention core takes N tokens of head width Dh."""
    return (N % 16 == 0 and 16 <= N <= MAX_TOKENS and Dh % 16 == 0
            and _core_smem(N, Dh) <= _MAX_SMEM)


def _check(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K2 takes bf16 activations, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"K2 takes (B, N, D) tokens, got shape {tuple(x.shape)}")
    B, N, D = x.shape
    if D % H:
        raise ValueError(f"D={D} is not divisible by H={H}")
    Dh = D // H
    if wqkv.shape != (3 * D, D) or wproj.shape != (D, D):
        raise ValueError(f"K2 weights must be (3D, D) and (D, D), got "
                         f"{tuple(wqkv.shape)} and {tuple(wproj.shape)}")
    for name, v, n in (("scale", scale_p, D), ("bias", bias_p, D),
                       ("bqkv", bqkv, 3 * D), ("bproj", bproj, D)):
        if v.shape != (n,):
            raise ValueError(f"K2 {name} must be ({n},), got {tuple(v.shape)}")
    if D % 64 or D > 1024:
        raise ValueError(f"K2 needs D a multiple of 64 and D <= 1024, got D={D}")
    if not supported_tokens(N, Dh):
        raise ValueError(f"K2's attention core does not take N={N}, Dh={Dh} "
                         f"(needs multiples of 16, N <= {MAX_TOKENS})")
    if not x.is_contiguous():
        raise ValueError("K2 needs contiguous activations")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)):
        raise NotImplementedError(
            "K2 has no backward kernel yet (ROADMAP.md, Queue 2: K2b); "
            "call it under torch.inference_mode() or torch.no_grad()")


def fused_attention_block(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int):
    """``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens.

    CPU tensors take :func:`attention_block_reference`; CUDA tensors launch
    K2 (bf16 activations, fp32 LN params and biases, weights cast to bf16).
    """
    if not uses_kernel(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj):
        return attention_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H)
    _check(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H)
    B, N, D = x.shape
    T = B * N
    Dh = D // H
    lib = load_library()
    wqkv_b = wqkv.to(torch.bfloat16).contiguous()
    wproj_b = wproj.to(torch.bfloat16).contiguous()
    s, bb = scale_p.float().contiguous(), bias_p.float().contiguous()
    bqkv_f, bproj_f = bqkv.float().contiguous(), bproj.float().contiguous()
    qkv = torch.empty((T, 3 * D), dtype=torch.bfloat16, device=x.device)
    att = torch.empty((T, D), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    stream = current_stream(x.device)
    check_status(lib.ddm_ln_gemm(x.data_ptr(), s.data_ptr(), bb.data_ptr(), wqkv_b.data_ptr(),
                                 bqkv_f.data_ptr(), qkv.data_ptr(), T, D, 3 * D, 0, stream),
                 "K2 ln_gemm")
    check_status(lib.ddm_attention_core(qkv.data_ptr(), att.data_ptr(), B, N, H, Dh,
                                        Dh ** -0.5, stream),
                 "K2 attention_core")
    check_status(lib.ddm_gemm_residual(att.data_ptr(), wproj_b.data_ptr(), bproj_f.data_ptr(),
                                       x.data_ptr(), out.data_ptr(), T, D, D, stream),
                 "K2 gemm_residual")
    LAUNCHES.add()
    return out
