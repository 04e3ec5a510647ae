"""The DiT tail in one pass: ``f32(bf16(LN(x)) w + b)`` over (T, D) rows.

Port of X4, the fused final LayerNorm + unembed projection of
``tools/exp_ln_dense.patch`` (``fused_ln_dense``, kernels
``_ln_dense_fwd_kernel`` and ``_ln_dense_bwd_kernel``). The JAX model
computes the same function unfused (``DDDMDiT.head_tokens``:
``final_norm(h).astype(dtype)`` then ``unembed(h).astype(float32)``).
:func:`fused_ln_dense` is a ``torch.autograd.Function``: on CUDA tensors
it launches X4f forward and X4b backward (``csrc/ln_dense.cu``, hand-written
CUDA) or raises; on CPU tensors, and wherever :func:`ln_dense_takes`
refuses the shape, it runs the plain pair :func:`ln_dense_reference` and
:func:`ln_dense_bwd_reference` on either device.

Layouts are the patch's: ``w`` is (D, K), ``b`` is (K,), the output fp32
(T, K). Numerics (both versions): fp32 LN with eps 1e-6, ``y`` rounded to
the compute dtype, ``y w`` accumulated in fp32 and rounded, ``b`` rounded
and added in the compute dtype, the sum returned in fp32. The backward is
the kernel's, step by step, not autograd of the forward: the cotangent is
rounded for the two products (``dW = y^T dO``, ``dy = dO w^T``), whose fp32
sums are never rounded (autograd of a bf16 product would round dW), ``db``
sums the fp32 cotangent, and the LayerNorm backward runs in fp32.
"""

from __future__ import annotations

import torch

from . import gemm
from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel
from .mlp_block import layer_norm, layer_norm_bwd, ln_stats

__all__ = [
    "fused_ln_dense",
    "ln_dense_reference",
    "ln_dense_bwd_reference",
    "ln_dense_bwd",
    "ln_dense_takes",
    "LN_DENSE_MAX_K",
    "FWD_LAUNCHES",
    "BWD_LAUNCHES",
]

LN_DENSE_MAX_K = 512
FWD_LAUNCHES = LaunchCounter("X4f")
BWD_LAUNCHES = LaunchCounter("X4b")
_BM = 64  # rows a block of X4f / X4b takes


def ln_dense_takes(T: int, D: int, K: int) -> bool:
    """Whether X4f/X4b take (T, D) rows onto K outputs: every T, every D %
    128 == 0 and every K <= 512, the shape terms of the JAX gate
    ``_ln_dense_ok``. Its last term, ``D K 8 + rb D 22 < 14 MiB``, bounds
    the blocks of a TPU core's scoped VMEM; the kernels here stream the
    depth in 64-column chunks, so it is not copied (at rb 1024 it would
    refuse every DiT-B/L/XL tail)."""
    return T >= 1 and D >= 128 and D % 128 == 0 and 1 <= K <= LN_DENSE_MAX_K


def ln_dense_reference(x, scale, bias, w, b):
    """Plain version of X4f: ``f32(bf16(LN(x)) w + b)`` in ``x.dtype``
    (``ln_dense_reference`` of the patch); ``w`` (D, K)."""
    dtype = x.dtype
    y = layer_norm(x.float(), scale, bias).to(dtype)
    return (torch.matmul(y, w.to(dtype)) + b.to(dtype)).float()


def ln_dense_bwd_reference(x, scale, bias, w, dout):
    """Plain version of X4b: the gradients ``(dx, dscale, dbias, dw, db)``
    for the cotangent ``dout`` (T, K), the kernel's arithmetic in torch: the
    cotangent rounded to ``x.dtype`` for ``dw = y^T dout`` and ``dy = dout
    w^T`` (fp32 sums of rounded operands), ``db`` the fp32 column sums of
    ``dout``, then the fp32 LayerNorm backward; ``dx`` in ``x.dtype``."""
    dtype = x.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    xhat, inv = ln_stats(x.float())
    y = rnd(xhat * scale.float() + bias.float())
    do = dout.float()
    dob = rnd(do)
    dw = y.t() @ dob
    db = do.sum(0)
    dy = dob @ rnd(w).t()
    dx, dscale, dbias = layer_norm_bwd(dy, xhat, inv, scale, 0.0)
    return dx.to(dtype), dscale, dbias, dw, db


def _check(x, scale, bias, w, b, kernel="X4"):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bf16 activations, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{kernel} takes (T, D) rows, got shape {tuple(x.shape)}")
    T, D = x.shape
    K = w.shape[-1]
    if w.shape != (D, K):
        raise ValueError(f"{kernel} weight must be (D, K) = ({D}, K), got {tuple(w.shape)}")
    for name, v, n in (("scale", scale, D), ("bias", bias, D), ("b", b, K)):
        if v is not None and v.shape != (n,):
            raise ValueError(f"{kernel} {name} must be ({n},), got {tuple(v.shape)}")


def _rows(x):
    """x as contiguous rows on a 16-byte boundary (the kernels' vector loads)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _operands(scale, bias, w, b=None):
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return f32(scale), f32(bias), w.to(torch.bfloat16).contiguous(), None if b is None else f32(b)


def _x4f(x, scale, bias, w, b):
    T, D = x.shape
    K = w.shape[1]
    x = _rows(x)
    s, bb, wb, bf = _operands(scale, bias, w, b)
    out = torch.empty((T, K), dtype=torch.float32, device=x.device)
    check_status(load_library().ddm_ln_dense_fwd(
        x.data_ptr(), s.data_ptr(), bb.data_ptr(), wb.data_ptr(), bf.data_ptr(), out.data_ptr(),
        T, D, K, current_stream(x.device)), "ln_dense_fwd")
    FWD_LAUNCHES.add()
    return out


def _x4b(x, scale, bias, w, dout):
    T, D = x.shape
    K = w.shape[1]
    if dout.shape != (T, K):
        raise ValueError(f"X4b cotangent must be {(T, K)}, got {tuple(dout.shape)}")
    x = _rows(x)
    s, bb, wb, _ = _operands(scale, bias, w)
    do = dout.float().contiguous()
    dev = x.device
    nblk = -(-T // _BM)
    splits, rows = gemm.tn_splits(T, D, K, gemm.sm_count(dev.index or 0))
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    dx = torch.empty_like(x)
    # scratch: the rows' statistics, the LN and db partials per 64 rows, dW's
    # split partials (held here until the launches are queued)
    stats, part_ln, part_db, ws = empty(T, 2), empty(nblk, 2, D), empty(nblk, K), \
        empty(splits, D, K)
    sums, dw, db = empty(2, D), empty(D, K), empty(K)
    check_status(load_library().ddm_ln_dense_bwd(
        *(t.data_ptr() for t in (x, s, bb, wb, do, dx, stats, part_ln, part_db, ws, sums, dw,
                                 db)),
        T, D, K, splits, rows, current_stream(dev)), "ln_dense_bwd")
    BWD_LAUNCHES.add()
    return dx, sums[0], sums[1], dw, db


def ln_dense_bwd(x, scale, bias, w, dout):
    """The gradients of :func:`fused_ln_dense` over (T, D) rows for the fp32
    cotangent ``dout`` (T, K): X4b on CUDA tensors where
    :func:`ln_dense_takes` takes the shape (or raise), else
    :func:`ln_dense_bwd_reference`."""
    T, D = x.shape
    if not uses_kernel(x, scale, bias, w, dout) or not ln_dense_takes(T, D, w.shape[-1]):
        return ln_dense_bwd_reference(x, scale, bias, w, dout)
    _check(x, scale, bias, w, None, kernel="X4b")
    return _x4b(x, scale, bias, w, dout)


class _LnDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, w, b):
        T, D = x.shape
        kernel = uses_kernel(x, scale, bias, w, b) and ln_dense_takes(T, D, w.shape[-1])
        if kernel:
            _check(x, scale, bias, w, b, kernel="X4f")
        # the weight in the compute dtype, cast once for both passes
        wc = w.to(x.dtype).contiguous()
        ctx.save_for_backward(x, scale, bias, wc)
        ctx.dtypes = tuple(t.dtype for t in (x, scale, bias, w, b))
        return (_x4f if kernel else ln_dense_reference)(x, scale, bias, wc, b)

    @staticmethod
    def backward(ctx, dout):
        grads = ln_dense_bwd(*ctx.saved_tensors, dout)
        # each gradient in its input's dtype (the weights may be fp32 parameters)
        return tuple(g.to(dtype) for g, dtype in zip(grads, ctx.dtypes))


def fused_ln_dense(x, scale, bias, w, b):
    """``f32(bf16(LN(x)) w + b)`` over the last axis of ``x`` (any leading
    shape, D features) with ``w`` (D, K) and ``b`` (K,), with its backward:
    the DiT's final LayerNorm and unembed projection (X4).

    CUDA tensors launch X4f and X4b (bf16 activations; fp32 LN parameters
    and bias; the weight cast to bf16) where :func:`ln_dense_takes` takes
    the shape, or raise; CPU tensors, and refused shapes on either device,
    take :func:`ln_dense_reference` and :func:`ln_dense_bwd_reference`.
    """
    lead, D = x.shape[:-1], x.shape[-1]
    out = _LnDense.apply(x.reshape(-1, D), scale, bias, w, b)
    return out.reshape(*lead, out.shape[-1])
