"""A whole pre-LN DiT block forward in one kernel (X2), an experiment.

Port of ``tools/exp_whole_block.py`` (``merged_call``, kernel
``_whole_fwd_kernel``): ``a = x + proj(MHA(qkv(LN1 x)))`` then ``out = a +
W2 gelu(W1 LN2 a + b1) + b2`` over (B, N, D) tokens, with ``a`` kept on chip
between the halves. The JAX package keeps the two half-block kernels on its
model (the merged kernel was 3% slower over an 8-block chain on the TPU),
and so does the port: nothing in ``models/`` calls :func:`whole_block_fwd`;
``scripts/torch_exp_whole_block.py`` times it against the pair.

On CUDA tensors :func:`whole_block_fwd` launches X2f (``csrc/whole_block.cu``),
whose output is bit for bit the K2f -> K1f pair composed from the WMMA
products around the resident core (the pair before both half-blocks moved
to the wgmma products, whose sums run in another order: the card test
composes it); on CPU tensors it
runs :func:`whole_block_reference`, the pair's plain versions in turn. It is
forward only, as X2 is. It takes whole images of N <= 64 tokens (N % 16 ==
0) at D 128, 256 or 384 (DiT-S/4's widths: D 384 over 6 heads, F 1536),
head widths Dh % 16 == 0 up to 128, F % 64 == 0 (:func:`whole_block_takes`), on
either device, and refuses every other shape.
"""

from __future__ import annotations

import torch

from .attention import attention_block_reference
from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel
from .mlp_block import mlp_block_reference

__all__ = ["whole_block_fwd", "whole_block_reference", "whole_block_takes", "LAUNCHES"]

LAUNCHES = LaunchCounter("X2f")


def whole_block_reference(x, s1, b1, wqkv, bqkv, wproj, bproj, s2, b2, w1, bb1, w2, bb2,
                          H: int):
    """Plain version of X2f: the attention half-block's plain version, then
    the MLP half-block's, on (B, N, D) tokens in ``x.dtype`` (the pair's
    rounding of ``a`` between them)."""
    B, N, D = x.shape
    a = attention_block_reference(x, s1, b1, wqkv, bqkv, wproj, bproj, H)
    out = mlp_block_reference(a.reshape(B * N, D), s2, b2, w1, bb1, w2, bb2)
    return out.reshape(B, N, D)


def whole_block_takes(B: int, N: int, D: int, H: int, F: int) -> bool:
    """Whether X2f takes the shape: whole images of 16 <= N <= 64 tokens (N
    % 16 == 0), D in (128, 256, 384), Dh = D / H a multiple of 16 up to 128
    (the widest head whose tiles fit a block's shared memory beside its two
    panels; ``csrc/whole_block.cu`` asserts the bound), F a multiple of 64."""
    if B < 1 or N < 16 or N > 64 or N % 16 or D not in (128, 256, 384) or H < 1 or D % H:
        return False
    Dh = D // H
    return Dh % 16 == 0 and Dh <= 128 and F >= 64 and F % 64 == 0


def _check(args, H):
    x = args[0]
    if x.dim() != 3:
        raise ValueError(f"X2f takes (B, N, D) tokens, got shape {tuple(x.shape)}")
    B, N, D = x.shape
    F = args[9].shape[0]
    if not whole_block_takes(B, N, D, H, F):
        raise NotImplementedError(
            f"X2f, the whole-block experiment, takes whole images of N <= 64 tokens (N % 16 "
            f"== 0) at D 128, 256 or 384 with Dh % 16 == 0, Dh <= 128 and F % 64 == 0 (DiT-S/4's "
            f"widths); got (B={B}, N={N}, D={D}, H={H}, F={F}). Other shapes are ROADMAP.md "
            "item 14's")
    shapes = ((D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,), (F, D), (F,),
              (D, F), (D,))
    for i, (t, shape) in enumerate(zip(args[1:], shapes)):
        if tuple(t.shape) != shape:
            raise ValueError(f"X2f operand {i + 1} must be {shape}, got {tuple(t.shape)}")


def whole_block_fwd(x, s1, b1, wqkv, bqkv, wproj, bproj, s2, b2, w1, bb1, w2, bb2, H: int):
    """``a = x + proj(MHA(qkv(LN1 x)))``, then ``a + W2 gelu(W1 LN2 a + b1)
    + b2``, over (B, N, D) tokens, forward only: X2f on CUDA tensors (bf16
    activations; fp32 LN parameters and biases; weights cast to bf16), the
    WMMA-composed K2f -> K1f pair's output bit for bit;
    :func:`whole_block_reference` on
    CPU tensors. Shapes outside :func:`whole_block_takes` raise
    ``NotImplementedError`` on either device."""
    args = (x, s1, b1, wqkv, bqkv, wproj, bproj, s2, b2, w1, bb1, w2, bb2)
    _check(args, H)
    if not uses_kernel(*args):
        return whole_block_reference(*args, H)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"X2f takes bf16 activations, got {x.dtype}")
    B, N, D = x.shape
    F = w1.shape[0]
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    ops = (x.contiguous(), f32(s1), f32(b1), bf(wqkv), f32(bqkv), bf(wproj), f32(bproj),
           f32(s2), f32(b2), bf(w1), f32(bb1), bf(w2), f32(bb2))
    out = torch.empty_like(ops[0])
    check_status(load_library().ddm_whole_block_fwd(
        *(t.data_ptr() for t in ops), out.data_ptr(), B, N, D, H, F, (D // H) ** -0.5,
        current_stream(x.device)), "whole_block_fwd")
    LAUNCHES.add()
    return out
