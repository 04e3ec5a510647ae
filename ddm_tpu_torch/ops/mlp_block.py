"""Transformer-MLP half-block ``x + gelu(LN(x) W1^T + b1) W2^T + b2``.

Port of ``ddm_tpu/ops/mlp_block.py``. :func:`fused_mlp_block` is a
``torch.autograd.Function``. On CUDA tensors its forward launches kernel K1f,
two hand-written wgmma products fed by a TMA ring (``csrc/gemm_wg.cu``): an
LN-prologue product with a ``+b1``/exact-erf GELU epilogue, then a product
with a ``x + (acc + b2)`` epilogue. It saves only its inputs, and its
backward launches K1b, which recomputes the forward as the TPU kernel does:
the LN-prologue product writing g, gelu'(h) and y, the dW2, dh, dW1 and dy
products (``csrc/gemm_wg.cu``; the weight gradients split over T in fixed
row ranges, summed in a fixed order), then the LayerNorm backward
(``csrc/gemm_bwd.cu``). The F-chunked forward K6f runs on the same ring, two
products a hidden chunk: the LN-prologue product with the GELU epilogue on
the W1 row chunk, then the partial product on the W2 column chunk, read in
place, with an fp32 store, add or final epilogue. The tensor-parallel K6b
runs K1b's chain on the same ring. On CPU tensors the same Function runs
the plain versions, :func:`mlp_block_reference` and
:func:`mlp_block_bwd_reference`, with the same dtype plan.

Weights use ``nn.Linear``'s layout: ``w1`` is (F, D), ``w2`` is (D, F).

Numerics (both versions): LN statistics in fp32 with eps 1e-6; bf16 matmul
operands with fp32 accumulation; exact-erf GELU in fp32, rounded to the
compute dtype; the residual added in fp32 and rounded once.

``fast_gelu=True`` (the JAX package's ``DDM_TPU_FAST_GELU=1``, read there at
trace time; an explicit argument here) takes ``h sigmoid(1.702 h)`` and its
derivative ``s (1 + 1.702 h (1 - s))`` with one sigmoid shared
(``_act``/``_act_fwd_bwd``) in place of the erf GELU, in the kernels' GELU
epilogues (a launch parameter) and in every plain version. With it off
every path computes what it computed before the switch existed. The JAX
reference ``mlp_block_reference`` adds the residual after rounding, while
the TPU kernel adds in fp32 and rounds once; the port follows the kernel.
The backward follows ``_bwd_body``: dW and bias gradients in fp32, dh
rounded to bf16 for the products but db1 summed over the unrounded dh.

Tiers (:func:`ddm_tpu_torch.ops.tiers.mlp_tier`, the JAX ladder's choice
from the shapes): ``fused`` (DiT-S widths) is K1f + K1b; ``fwdonly``
(DiT-B) runs K1f forward; ``fchunked`` (DiT-L) runs the forward as k
partial products K6f over column chunks of the hidden axis
(``_partial_fwd_kernel`` on the TPU; :func:`mlp_partial_reference` is its
plain version),
summed in fp32 in chunk order and rounded once as ``(x + sum) + b2``. In
both wide tiers the JAX backward is XLA's autodiff of the plain half-block;
the port runs K1b's chain there, which keeps dW in fp32 where XLA rounds the
weight cotangents to bf16. Where the ladder has no tier the JAX package
runs its jnp reference, and the port its plain versions, forward and
backward, on CUDA tensors too.

Past D 1344 (D % 128 == 0 up to 4096) the ladder still runs kernels:
``fchunked`` at k 2-8 (MLP ratio 4 up to D 2560, ratio 2 up to 3584,
ratio 1 up to 4096; e.g. SD3-Medium's width, D 1536 and F 6144, at k 8),
and ``fwdonly`` at ratio 1 and D 1408, 1664 and 1792. The LN-prologue
product of K1f, K1b and K6f takes any D % 64 == 0 (the x chunks stream
through its ring; its LN tables fit up to D 4096), and K1b's LayerNorm
backward takes 4 warps a block past D 3584.

The tensor-parallel partial (``fused_mlp_partial`` of
``ddm_tpu/ops/mlp_block.py:652``): :func:`fused_mlp_partial` computes
``gelu(LN(x) w1^T + b1) w2^T`` in fp32 with no output bias and no residual,
on a rank's shard of the hidden axis; the caller all-reduces it and adds
``b2`` and the residual once. Its dispatch is the JAX ladder's without the
F-chunked tier: at ``fused`` and ``fwdonly`` the forward is one K6f
(:func:`mlp_partial_reference` is its plain version) and the backward is
K6b (``_partial_bwd_kernel``; :func:`mlp_partial_bwd_reference`), K1b's
chain with an fp32 cotangent rounded to bf16 for the products, no db2, and
the LayerNorm backward without the residual. In the ``fwdonly`` tier the
JAX backward is XLA's autodiff of the plain partial; the port runs K6b
there, as it runs K1b in the wide tiers. Where the ladder has no tier, both
directions take the plain versions on any device.
"""

from __future__ import annotations

import math

import torch

from . import gemm, tiers
from .kernel_config import LaunchCounter, uses_kernel

__all__ = [
    "fused_mlp_block",
    "mlp_block_reference",
    "mlp_block_fchunked_reference",
    "mlp_partial_reference",
    "mlp_partial_bwd_reference",
    "mlp_partial_bwd",
    "fused_mlp_partial",
    "mlp_block_bwd",
    "mlp_block_bwd_reference",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "PARTIAL_LAUNCHES",
    "PARTIAL_BWD_LAUNCHES",
    "layer_norm",
    "gelu",
]

LN_EPS = 1e-6
LAUNCHES = LaunchCounter("K1f")
BWD_LAUNCHES = LaunchCounter("K1b")
PARTIAL_LAUNCHES = LaunchCounter("K6f")  # one per hidden chunk
PARTIAL_BWD_LAUNCHES = LaunchCounter("K6b")
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)
_FAST_GELU_C = 1.702  # x sigmoid(1.702 x), Hendrycks & Gimpel (2016) eq. 5


def ln_stats(xf: torch.Tensor):
    """``(xhat, inv)`` of an fp32 LayerNorm over the last axis, eps 1e-6,
    centred variance."""
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    return xc * inv, inv


def layer_norm(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, eps 1e-6, centred variance."""
    xhat, _ = ln_stats(xf)
    return xhat * scale.float() + bias.float()


def layer_norm_bwd(dy, xhat, inv, scale, dres):
    """LayerNorm backward plus the residual cotangent, all fp32:
    ``(dx, dscale, dbias)`` over rows of the last axis."""
    dscale = (dy * xhat).sum(0)
    dbias = dy.sum(0)
    dxhat = dy * scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return dres + inv * (dxhat - m1 - xhat * m2), dscale, dbias


def matmul_f32(a: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ w^T`` on operands rounded to ``dtype``, accumulated in fp32."""
    return torch.matmul(a.to(dtype).float(), w.to(dtype).float().t())


def gelu(h: torch.Tensor, fast_gelu: bool = False) -> torch.Tensor:
    """The exact-erf GELU, or with ``fast_gelu`` ``h sigmoid(1.702 h)``
    (``_act``), in ``h``'s dtype."""
    if fast_gelu:
        return h * torch.sigmoid(_FAST_GELU_C * h)
    return torch.nn.functional.gelu(h, approximate="none")


def mlp_block_reference(x, scale, bias, w1, b1, w2, b2, fast_gelu: bool = False):
    """Plain PyTorch version of K1f over (T, D) rows in ``x.dtype``."""
    dtype = x.dtype
    xf = x.float()
    y = layer_norm(xf, scale, bias).to(dtype)
    h = matmul_f32(y, w1, dtype) + b1.float()
    g = gelu(h, fast_gelu).to(dtype)
    out = matmul_f32(g, w2, dtype) + b2.float()
    return (xf + out).to(dtype)


def mlp_partial_reference(x, scale, bias, w1, b1, w2, fast_gelu: bool = False):
    """Plain PyTorch version of K5/K6f: ``gelu(LN(x) w1^T + b1) w2^T`` over
    (T, D) rows in fp32, no output bias, no residual; ``w1 (Fc, D)``, ``w2
    (D, Fc)`` (a chunk of the hidden axis, or a tensor-parallel shard)."""
    dtype = x.dtype
    y = layer_norm(x.float(), scale, bias).to(dtype)
    h = matmul_f32(y, w1, dtype) + b1.float()
    g = gelu(h, fast_gelu).to(dtype)
    return matmul_f32(g, w2, dtype)


def _chunks(w1, b1, w2, k: int):
    """The k hidden-axis chunks ``(w1 rows, b1, w2 columns)``, as views."""
    fc = w1.shape[0] // k
    return [(w1[c * fc:(c + 1) * fc], b1[c * fc:(c + 1) * fc], w2[:, c * fc:(c + 1) * fc])
            for c in range(k)]


def mlp_block_fchunked_reference(x, scale, bias, w1, b1, w2, b2, k: int,
                                 fast_gelu: bool = False):
    """Plain version of the F-chunked forward (``_fchunked_fwd_call``): the
    k fp32 partials summed in chunk order, then ``(x + sum) + b2`` rounded
    once to ``x.dtype``."""
    acc = None
    for w1c, b1c, w2c in _chunks(w1, b1, w2, k):
        part = mlp_partial_reference(x, scale, bias, w1c, b1c, w2c, fast_gelu)
        acc = part if acc is None else acc + part
    return ((x.float() + acc) + b2.float()).to(x.dtype)


def _gelu_and_grad(h: torch.Tensor, fast_gelu: bool = False):
    """``(gelu(h), gelu'(h))`` with one exact erf shared, or with
    ``fast_gelu`` one sigmoid (``_act_fwd_bwd``)."""
    if fast_gelu:
        s = torch.sigmoid(_FAST_GELU_C * h)
        return h * s, s * (1.0 + _FAST_GELU_C * h * (1.0 - s))
    erf_h = torch.erf(h * _INV_SQRT2)
    return 0.5 * h * (1.0 + erf_h), 0.5 * (1.0 + erf_h) + h * _INV_SQRT2PI * torch.exp(-0.5 * h * h)


def mlp_block_bwd_reference(x, scale, bias, w1, b1, w2, b2, dout, fast_gelu: bool = False):
    """Plain PyTorch version of K1b: the gradients of :func:`fused_mlp_block`
    with respect to ``(x, scale, bias, w1, b1, w2, b2)`` for the cotangent
    ``dout``, following ``_bwd_body``'s rounding plan (products of operands
    rounded to ``x.dtype``, accumulated in fp32)."""
    dtype = x.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    xf = x.float()
    xhat, inv = ln_stats(xf)
    y = rnd(xhat * scale.float() + bias.float())
    h = y @ rnd(w1).t() + b1.float()
    gf, dfac = _gelu_and_grad(h, fast_gelu)
    g = rnd(gf)
    do = dout.float()
    dob = rnd(do)
    dw2 = dob.t() @ g
    db2 = do.sum(0)
    dh = (dob @ rnd(w2)) * dfac
    dhb = rnd(dh)
    dw1 = dhb.t() @ y
    db1 = dh.sum(0)
    dy = dhb @ rnd(w1)
    dx, dscale, dbias = layer_norm_bwd(dy, xhat, inv, scale, do)
    return dx.to(dtype), dscale, dbias, dw1, db1, dw2, db2


def mlp_partial_bwd_reference(x, scale, bias, w1, b1, w2, do, fast_gelu: bool = False):
    """Plain PyTorch version of K6b: the gradients of
    :func:`mlp_partial_reference` with respect to ``(x, scale, bias, w1,
    b1, w2)`` for the fp32 cotangent ``do``, by ``_bwd_body``'s rounding
    plan with no db2 and no residual: ``do`` rounded to ``x.dtype`` for the
    products, db1 summed over the unrounded dh, dx the LayerNorm backward
    alone."""
    dtype = x.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    xhat, inv = ln_stats(x.float())
    y = rnd(xhat * scale.float() + bias.float())
    h = y @ rnd(w1).t() + b1.float()
    gf, dfac = _gelu_and_grad(h, fast_gelu)
    dob = rnd(do.float())
    dw2 = dob.t() @ rnd(gf)
    dh = (dob @ rnd(w2)) * dfac
    dhb = rnd(dh)
    dw1 = dhb.t() @ y
    dx, dscale, dbias = layer_norm_bwd(dhb @ rnd(w1), xhat, inv, scale, 0.0)
    return dx.to(dtype), dscale, dbias, dw1, dh.sum(0), dw2


def _check(x, scale, bias, w1, b1, w2, b2, kernel="K1"):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bf16 activations, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{kernel} takes (T, D) rows, got shape {tuple(x.shape)}")
    T, D = x.shape
    F = w1.shape[0]
    if w1.shape != (F, D) or w2.shape != (D, F):
        raise ValueError(f"{kernel} weights must be (F, D) and (D, F), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    for name, v, n in (("scale", scale, D), ("bias", bias, D), ("b1", b1, F), ("b2", b2, D)):
        if v is not None and v.shape != (n,):
            raise ValueError(f"{kernel} {name} must be ({n},), got {tuple(v.shape)}")
    if D % 64 or F % 64:
        raise ValueError(f"{kernel} needs D and F multiples of 64, got D={D}, F={F}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel} needs contiguous activations")


def _kernel_operands(scale, bias, w1, b1, w2, b2=None):
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return f32(scale), f32(bias), bf(w1), f32(b1), bf(w2), None if b2 is None else f32(b2)


def _k1f(x, scale, bias, w1, b1, w2, b2, fast_gelu=False):
    s, bb, w1b, b1f, w2b, b2f = _kernel_operands(scale, bias, w1, b1, w2, b2)
    hidden, _, _ = gemm.ln_gemm_wg(x, s, bb, w1b, b1f, gemm.EPI_GELU, fast_gelu=fast_gelu)
    out = gemm.gemm_residual_wg(hidden, w2b, b2f, x)
    LAUNCHES.add()
    return out


def _k6f(x, s, bb, w1c, b1c, w2c, epi, acc, b2f=None, fast_gelu=False):
    """One hidden chunk on the wgmma ring: the LN-prologue product with bias
    + GELU on the W1 row chunk, then the fp32-partial product on the W2
    column chunk, read in place (``PART_STORE``, ``PART_ADD`` or
    ``PART_FINAL_RES``)."""
    hidden, _, _ = gemm.ln_gemm_wg(x, s, bb, w1c, b1c, gemm.EPI_GELU, fast_gelu=fast_gelu)
    out = gemm.gemm_partial_wg(hidden, w2c, epi, acc, b2f, x)
    PARTIAL_LAUNCHES.add()
    return out


def _k6f_chunked(x, scale, bias, w1, b1, w2, b2, k, fast_gelu=False):
    s, bb, w1b, b1f, w2b, b2f = _kernel_operands(scale, bias, w1, b1, w2, b2)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    last = k - 1
    for c, (w1c, b1c, w2c) in enumerate(_chunks(w1b, b1f, w2b, k)):
        epi = gemm.PART_STORE if c == 0 else gemm.PART_FINAL_RES if c == last else gemm.PART_ADD
        out = _k6f(x, s, bb, w1c, b1c, w2c, epi, acc, b2f, fast_gelu)
    return out


def _bwd_chain(x, s, bb, w1b, b1f, w2b, dob, residual, fast_gelu):
    """K1b's chain on the wgmma ring for the bf16 cotangent ``dob``: the
    recompute (g, gelu'(h) and y), dW2, dh with db1, dW1, dy in fp32, then
    the LayerNorm backward. With ``residual`` (the half-block, K1b) dW2's
    product also sums dO's columns (db2) and ``ln_bwd`` adds dO, the
    residual's cotangent; without it (the tensor-parallel partial, K6b)
    neither, and db2 is None."""
    g, dfac, y = gemm.ln_gemm_wg(x, s, bb, w1b, b1f, gemm.EPI_GELU_GRAD, with_y=True,
                                 fast_gelu=fast_gelu)
    dw2, db2 = gemm.expert_tn_wg(dob, g, with_colsum=residual)
    del g
    dhb, db1 = gemm.expert_nn_wg(dob, w2b, gemm.NN_DGELU, dfac=dfac)
    del dfac
    dw1, _ = gemm.expert_tn_wg(dhb, y)
    dy = gemm.expert_nn_wg(dhb, w1b, gemm.NN_F32)
    del dhb
    dx, dscale, dbias = gemm.ln_bwd(x, dy, dob if residual else None, s)
    return dx, dscale, dbias, dw1, db1, dw2, db2


def _k1b(x, scale, bias, w1, b1, w2, b2, dout, fast_gelu=False):
    if dout.shape != x.shape:
        raise ValueError(f"K1b cotangent must be {tuple(x.shape)}, got {tuple(dout.shape)}")
    s, bb, w1b, b1f, w2b, _ = _kernel_operands(scale, bias, w1, b1, w2, b2)
    dob = dout.to(torch.bfloat16).contiguous()
    grads = _bwd_chain(x, s, bb, w1b, b1f, w2b, dob, True, fast_gelu)
    BWD_LAUNCHES.add()
    return grads


def _k6f_partial(x, scale, bias, w1, b1, w2, fast_gelu=False):
    """The tensor-parallel partial on the card: one K6f into a new fp32 (T, D)."""
    s, bb, w1b, b1f, w2b, _ = _kernel_operands(scale, bias, w1, b1, w2)
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _k6f(x, s, bb, w1b, b1f, w2b, gemm.PART_STORE, acc, fast_gelu=fast_gelu)
    return acc


def _k6b(x, scale, bias, w1, b1, w2, do, fast_gelu=False):
    if do.shape != x.shape:
        raise ValueError(f"K6b cotangent must be {tuple(x.shape)}, got {tuple(do.shape)}")
    s, bb, w1b, b1f, w2b, _ = _kernel_operands(scale, bias, w1, b1, w2)
    dob = gemm.cast_bf16(do.float())
    grads = _bwd_chain(x, s, bb, w1b, b1f, w2b, dob, False, fast_gelu)[:-1]
    PARTIAL_BWD_LAUNCHES.add()
    return grads


def mlp_partial_bwd(x, scale, bias, w1, b1, w2, do, fast_gelu: bool = False):
    """The gradients of :func:`fused_mlp_partial` for the fp32 cotangent
    ``do``: K6b on CUDA tensors (or raise), :func:`mlp_partial_bwd_reference`
    on CPU tensors."""
    if not uses_kernel(x, scale, bias, w1, b1, w2, do):
        return mlp_partial_bwd_reference(x, scale, bias, w1, b1, w2, do, fast_gelu)
    _check(x, scale, bias, w1, b1, w2, None, kernel="K6b")
    return _k6b(x, scale, bias, w1, b1, w2, do, fast_gelu)


class _MLPPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, fast_gelu):
        args = (x, scale, bias, w1, b1, w2)
        ctx.save_for_backward(*args)
        ctx.fast_gelu = fast_gelu
        tier = tiers.mlp_tier(*x.shape, w1.shape[0])
        ctx.plain = not uses_kernel(*args) or tier is None or tier[0] == "fchunked"
        if ctx.plain:
            return mlp_partial_reference(*args, fast_gelu)
        _check(x, scale, bias, w1, b1, w2, None, kernel="K6f")
        return _k6f_partial(*args, fast_gelu)

    @staticmethod
    def backward(ctx, do):
        args = ctx.saved_tensors
        grads = (mlp_partial_bwd_reference(*args, do, ctx.fast_gelu) if ctx.plain else
                 mlp_partial_bwd(*args, do, ctx.fast_gelu))
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None,)


def fused_mlp_partial(x, scale, bias, w1, b1, w2, fast_gelu: bool = False):
    """``gelu(LN(x) w1^T + b1) w2^T`` over (T, D) rows in fp32, with its
    backward: a tensor-parallel rank's partial product before the
    all-reduce, with no output bias and no residual (``w1 (F_local, D)``,
    ``w2 (D, F_local)``).

    CUDA tensors launch K6f forward and K6b backward where the JAX ladder
    has the ``fused`` or ``fwdonly`` tier (or raise); elsewhere, and on CPU
    tensors, :func:`mlp_partial_reference` and
    :func:`mlp_partial_bwd_reference`.
    """
    return _MLPPartial.apply(x, scale, bias, w1, b1, w2, fast_gelu)


def mlp_block_bwd(x, scale, bias, w1, b1, w2, b2, dout, fast_gelu: bool = False):
    """The gradients of :func:`fused_mlp_block` for the cotangent ``dout``:
    K1b on CUDA tensors (or raise), :func:`mlp_block_bwd_reference` on CPU
    tensors."""
    if not uses_kernel(x, scale, bias, w1, b1, w2, b2, dout):
        return mlp_block_bwd_reference(x, scale, bias, w1, b1, w2, b2, dout, fast_gelu)
    _check(x, scale, bias, w1, b1, w2, b2)
    return _k1b(x, scale, bias, w1, b1, w2, b2, dout, fast_gelu)


class _MLPBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, fast_gelu):
        args = (x, scale, bias, w1, b1, w2, b2)
        ctx.save_for_backward(*args)
        ctx.fast_gelu = fast_gelu
        T, D = x.shape
        F = w1.shape[0]
        tier = tiers.mlp_tier(T, D, F)
        chunks = tier[1] if tier is not None and tier[0] == "fchunked" else 0
        ctx.plain = not uses_kernel(*args) or tier is None
        if ctx.plain:
            if chunks:
                return mlp_block_fchunked_reference(*args, chunks, fast_gelu)
            return mlp_block_reference(*args, fast_gelu)
        _check(*args)
        if chunks:
            return _k6f_chunked(*args, chunks, fast_gelu)
        return _k1f(*args, fast_gelu)

    @staticmethod
    def backward(ctx, dout):
        args = ctx.saved_tensors
        grads = (mlp_block_bwd_reference(*args, dout, ctx.fast_gelu) if ctx.plain else
                 mlp_block_bwd(*args, dout, ctx.fast_gelu))
        # each gradient in its input's dtype (the weights may be bf16 copies)
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None,)


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2, fast_gelu: bool = False):
    """``x + gelu(LN(x) w1^T + b1) w2^T + b2`` over (T, D) rows, with its
    backward.

    CPU tensors take :func:`mlp_block_reference` (or, in the ``fchunked``
    tier, :func:`mlp_block_fchunked_reference`) and
    :func:`mlp_block_bwd_reference`; CUDA tensors launch K1f, or k K6f in
    the ``fchunked`` tier, and K1b's chain (bf16 activations, fp32 LN params
    and biases, weights cast to bf16) or raise; where the JAX ladder has no
    tier, the plain versions on any device. Every D the ladder sends a tier
    runs its kernels: past D 1344 (``fwdonly`` at ratio 1 and D 1408-1792,
    ``fchunked`` up to D 4096) they run on the same wgmma ring. ``fast_gelu``
    takes the sigmoid GELU in every one of them.
    """
    return _MLPBlock.apply(x, scale, bias, w1, b1, w2, b2, fast_gelu)
