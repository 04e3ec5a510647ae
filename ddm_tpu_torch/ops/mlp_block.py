"""Transformer-MLP half-block ``x + gelu(LN(x) W1^T + b1) W2^T + b2``.

Port of ``ddm_tpu/ops/mlp_block.py`` (forward only). On a CUDA tensor
:func:`fused_mlp_block` launches kernel K1, two hand-written CUDA kernels
(``csrc/gemm.cu``): an LN-prologue GEMM with a ``+b1``/exact-erf GELU
epilogue, then a GEMM with a ``x + (acc + b2)`` epilogue. On a CPU tensor it
runs :func:`mlp_block_reference`, the plain version with the same dtype plan.

Weights use ``nn.Linear``'s layout: ``w1`` is (F, D), ``w2`` is (D, F).

Numerics (both versions): LN statistics in fp32 with eps 1e-6; bf16 matmul
operands with fp32 accumulation; exact-erf GELU in fp32, rounded to the
compute dtype; the residual added in fp32 and rounded once. The JAX
reference ``mlp_block_reference`` adds the residual after rounding, while
the TPU kernel adds in fp32 and rounds once; the port follows the kernel.
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

__all__ = ["fused_mlp_block", "mlp_block_reference", "LAUNCHES", "layer_norm"]

LN_EPS = 1e-6
LAUNCHES = LaunchCounter()


def layer_norm(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, eps 1e-6, centred variance."""
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def matmul_f32(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ w^T`` on operands rounded to ``dtype``, accumulated in fp32."""
    return torch.matmul(a.to(dtype).float(), w.to(dtype).float().t())


def mlp_block_reference(x, scale, bias, w1, b1, w2, b2):
    """Plain PyTorch version of K1 over (T, D) rows in ``x.dtype``."""
    dtype = x.dtype
    xf = x.float()
    y = layer_norm(xf, scale, bias).to(dtype)
    h = matmul_f32(y, w1, dtype) + b1.float()
    g = torch.nn.functional.gelu(h, approximate="none").to(dtype)
    out = matmul_f32(g, w2, dtype) + b2.float()
    return (xf + out).to(dtype)


def _check(x, scale, bias, w1, b1, w2, b2):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K1 takes bf16 activations, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"K1 takes (T, D) rows, got shape {tuple(x.shape)}")
    T, D = x.shape
    F = w1.shape[0]
    if w1.shape != (F, D) or w2.shape != (D, F):
        raise ValueError(f"K1 weights must be (F, D) and (D, F), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    for name, v, n in (("scale", scale, D), ("bias", bias, D), ("b1", b1, F), ("b2", b2, D)):
        if v.shape != (n,):
            raise ValueError(f"K1 {name} must be ({n},), got {tuple(v.shape)}")
    if D % 64 or F % 64 or D > 1024:
        raise ValueError(f"K1 needs D and F multiples of 64 and D <= 1024, got D={D}, F={F}")
    if not x.is_contiguous():
        raise ValueError("K1 needs contiguous activations")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, w1, b1, w2, b2)):
        raise NotImplementedError(
            "K1 has no backward kernel yet (ROADMAP.md, Queue 2: K1b); "
            "call it under torch.inference_mode() or torch.no_grad()")


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2):
    """``x + gelu(LN(x) w1^T + b1) w2^T + b2`` over (T, D) rows.

    CPU tensors take :func:`mlp_block_reference`; CUDA tensors launch K1
    (bf16 activations, fp32 LN params and biases, weights cast to bf16).
    """
    if not uses_kernel(x, scale, bias, w1, b1, w2, b2):
        return mlp_block_reference(x, scale, bias, w1, b1, w2, b2)
    _check(x, scale, bias, w1, b1, w2, b2)
    T, D = x.shape
    F = w1.shape[0]
    lib = load_library()
    w1b = w1.to(torch.bfloat16).contiguous()
    w2b = w2.to(torch.bfloat16).contiguous()
    s, bb = scale.float().contiguous(), bias.float().contiguous()
    b1f, b2f = b1.float().contiguous(), b2.float().contiguous()
    hidden = torch.empty((T, F), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    stream = current_stream(x.device)
    check_status(lib.ddm_ln_gemm(x.data_ptr(), s.data_ptr(), bb.data_ptr(), w1b.data_ptr(),
                                 b1f.data_ptr(), hidden.data_ptr(), T, D, F, 1, stream),
                 "K1 ln_gemm")
    check_status(lib.ddm_gemm_residual(hidden.data_ptr(), w2b.data_ptr(), b2f.data_ptr(),
                                       x.data_ptr(), out.data_ptr(), T, F, D, stream),
                 "K1 gemm_residual")
    LAUNCHES.add()
    return out
