"""Attention half-block ``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens.

Port of ``ddm_tpu/ops/attention.py`` (the half-block and its backward).
:func:`fused_attention_block` is a ``torch.autograd.Function``. On CUDA
tensors its forward launches kernel K2f, three hand-written CUDA kernels: an
LN-prologue qkv GEMM (``csrc/gemm.cu``), the attention core
(``csrc/attention.cu``), and the projection GEMM with a ``x + (acc +
bproj)`` epilogue (``csrc/gemm.cu``). It saves only its inputs, and its
backward recomputes the qkv GEMM and runs one attention core backward that
writes the attention output beside dq, dk and dv (``csrc/gemm.cu``,
``csrc/attention.cu``, ``csrc/gemm_bwd.cu``). On CPU tensors the same
Function runs the plain versions, :func:`attention_block_reference` and
:func:`attention_block_bwd_reference`.

The cores take 16 <= N <= 512 (N a multiple of 16, the JAX gate's N <= 512).
The forward core runs one block per (image, head, query tile) over full
score rows. The backward core runs one block per (image, head) where its
fp32 P and dP tiles fit shared memory (N <= 112 at Dh = 64), and past that
two passes, over query tiles (P, att, dq and the row terms) and over key
tiles (dk, dv). Both backward designs keep the same rounding plan and agree
bit for bit where both apply; the one-block design is the faster one there.

That backward is the port of two TPU kernels, which the JAX ladder picks
by the shapes (:func:`ddm_tpu_torch.ops.tiers.attention_tier`): the fused
backward K2b (``_blk_bwd_kernel``, DiT-S widths) and, at DiT-B and DiT-L
widths, the split backward K4 (``_blk_bwd_split_kernel``). The TPU splits
them for VMEM, which the H100 does not need, and they share one rounding
plan, so one chain serves both, :func:`attention_block_bwd_reference` is
the plain version of both, and the tier picks only which launch counter
rises. Shapes with no tier raise on CUDA tensors.

Layout: the fused qkv product emits ``[q | k | v]`` with heads contiguous in
each third, as the JAX package and the reference checkpoint order them.
Weights use ``nn.Linear``'s layout: ``wqkv`` is (3D, D), ``wproj`` (D, D).

Numerics (both versions): fp32 LN with eps 1e-6; qkv accumulated in fp32,
``+ bqkv``, rounded to the compute dtype; scores in fp32 with scale
Dh^-0.5; max-subtracted softmax in fp32; probabilities rounded to the
compute dtype; P V accumulated in fp32 and rounded; the projection
accumulated in fp32 and the residual added in fp32 before one rounding.
The backward keeps the fp32 P for dS, rounds dq, dk, dv and datt to the
compute dtype, and sums dbqkv over the rounded dqkv.

Long sequences (N >= 1024, the image sizes 128 to 512 at patch 4) take the
counterpart of the JAX ladder's rung 3 (``ddm_tpu/ops/attention.py:959-962``
with ``attention_fn=fused_attention``, which sends N > 512 to the flash
tier): the same qkv and projection GEMMs around the online-softmax core K8
(:mod:`ddm_tpu_torch.ops.flash`). Its forward saves ``(x, att, lse)`` as the
JAX flash VJP saves ``o`` and ``lse``, so the backward recomputes the qkv
GEMM but not the attention. The weight gradients stay fp32, where JAX's
XLA autodiff of rung 3 rounds them to bf16 (the VJP of the weights' bf16
cast).
"""

from __future__ import annotations

import torch

from . import flash, gemm, tiers
from .kernel_config import (
    LaunchCounter,
    check_status,
    current_stream,
    load_library,
    uses_kernel,
)
from .mlp_block import layer_norm, layer_norm_bwd, ln_stats, matmul_f32

__all__ = [
    "attention_reference",
    "attention_block_reference",
    "attention_core_bwd_att_reference",
    "attention_block_bwd",
    "attention_block_bwd_reference",
    "long_attention_block_reference",
    "long_attention_block_bwd_reference",
    "fused_attention_block",
    "supported_tokens",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "SPLIT_BWD_LAUNCHES",
    "MAX_TOKENS",
]

LAUNCHES = LaunchCounter("K2f")
BWD_LAUNCHES = LaunchCounter("K2b")
SPLIT_BWD_LAUNCHES = LaunchCounter("K4")
MAX_TOKENS = 512  # the JAX gate's N <= 512; the flash tier takes N >= 1024
_SINGLE_MAX_TOKENS = 128  # one backward block per (image, head) at most
_MAX_SMEM = 232448


def _heads(a: torch.Tensor, H: int) -> torch.Tensor:
    """(B, N, H*Dh) -> (B, H, N, Dh) in fp32."""
    B, N, D = a.shape
    return a.reshape(B, N, H, D // H).transpose(1, 2).float()


def _merge_heads(a: torch.Tensor) -> torch.Tensor:
    """(B, H, N, Dh) -> (B, N, H*Dh)."""
    B, H, N, Dh = a.shape
    return a.transpose(1, 2).reshape(B, N, H * Dh)


def attention_reference(q, k, v, H: int, scale=None):
    """Plain multi-head attention on (B, N, H*Dh) inputs, heads contiguous."""
    B, N, D = q.shape
    Dh = D // H
    if scale is None:
        scale = Dh ** -0.5
    dtype = q.dtype
    s = torch.matmul(_heads(q, H), _heads(k, H).transpose(-1, -2))
    p = torch.softmax(s * scale, dim=-1).to(dtype)
    o = torch.matmul(p.float(), _heads(v, H)).to(dtype)
    return _merge_heads(o)


def _flash_core(q, k, v, H: int):
    return flash.flash_attention_reference(q, k, v, H)[0]


def attention_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int,
                              attention_fn=attention_reference):
    """Plain PyTorch version of K2f over (B, N, D) tokens in ``x.dtype``;
    ``attention_fn`` is the attention core, as in the JAX function."""
    B, N, D = x.shape
    dtype = x.dtype
    xf = x.float()
    y = layer_norm(xf, scale_p, bias_p).to(dtype)
    qkv = (matmul_f32(y, wqkv, dtype) + bqkv.float()).to(dtype)
    q, k, v = qkv.split(D, dim=-1)
    o = attention_fn(q, k, v, H)
    out = matmul_f32(o, wproj, dtype) + bproj.float()
    return (xf + out).to(dtype)


def long_attention_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int):
    """Plain version of the long-sequence half-block: the plain K8f core."""
    return attention_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H,
                                      attention_fn=_flash_core)


def attention_core_bwd_att_reference(q, k, v, datt, H: int):
    """Plain version of K2b's and K4's attention core: ``(att, dq, dk, dv)``, all (B, N, D) in the compute
    dtype, from one fp32 P per (image, head): att = bf16(bf16(P) V),
    dv = bf16(bf16(P)^T datt), dS = bf16(scale * P * (dP - rowsum(P dP)))
    with dP = datt V^T in fp32, dq = bf16(dS K), dk = bf16(dS^T Q)."""
    dtype = q.dtype
    scale = (q.shape[-1] // H) ** -0.5
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    q, k, v, datt = (_heads(t, H) for t in (q, k, v, datt))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    pb = rnd(p)
    att = (pb @ v).to(dtype)
    dv = (pb.transpose(-1, -2) @ datt).to(dtype)
    dp = datt @ v.transpose(-1, -2)
    ds = rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale)
    return tuple(_merge_heads(t) for t in (att, (ds @ k).to(dtype),
                                           (ds.transpose(-1, -2) @ q).to(dtype), dv))


def _block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, dout,
                         core_bwd):
    """The half-block's gradients around an attention core: ``core_bwd(q,
    k, v, datt, H) -> (att, dq, dk, dv)``, all (B, N, D) in the compute
    dtype."""
    B, N, D = x.shape
    dtype = x.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    xf = x.float().reshape(B * N, D)
    xhat, inv = ln_stats(xf)
    y = rnd(xhat * scale_p.float() + bias_p.float())
    qkv = (y @ rnd(wqkv).t() + bqkv.float()).to(dtype).reshape(B, N, 3 * D)
    q, k, v = qkv.split(D, dim=-1)

    do = dout.float().reshape(B * N, D)
    dob = rnd(do)
    datt = (dob @ rnd(wproj)).to(dtype).reshape(B, N, D)
    att, *dqkv = core_bwd(q, k, v, datt, H)
    dwproj = dob.t() @ att.float().reshape(B * N, D)
    dbproj = do.sum(0)
    dqkv = torch.cat(dqkv, dim=-1).float().reshape(B * N, 3 * D)
    dwqkv = dqkv.t() @ y
    dbqkv = dqkv.sum(0)
    dy = dqkv @ rnd(wqkv)
    dx, dscale, dbias = layer_norm_bwd(dy, xhat, inv, scale_p, do)
    return (dx.reshape(B, N, D).to(dtype), dscale, dbias, dwqkv, dbqkv, dwproj, dbproj)


def attention_block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int,
                                  dout):
    """Plain PyTorch version of K2b and K4: the gradients of
    :func:`fused_attention_block` with respect to ``(x, scale, bias, wqkv,
    bqkv, wproj, bproj)`` for the cotangent ``dout``, following the rounding
    plan that ``_blk_bwd_kernel`` and ``_blk_bwd_split_kernel`` share (dW over
    the bf16 y, att and dqkv, dbproj over the fp32 cotangent, dbqkv over the
    rounded dqkv)."""
    return _block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, dout,
                                attention_core_bwd_att_reference)


def _flash_core_bwd(q, k, v, datt, H: int):
    att, lse = flash.flash_attention_reference(q, k, v, H)
    return (att, *flash.flash_attention_bwd_reference(q, k, v, att, lse, datt, H))


def long_attention_block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int,
                                       dout):
    """Plain version of the long-sequence half-block's backward: the same
    chain around the plain K8f/K8b core (lse replay, dsum from the bf16 o)."""
    return _block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, dout,
                                _flash_core_bwd)


def _core_smem(N: int, Dh: int, QT: int = 16) -> int:
    """Shared memory of the forward core at QT query rows (16: its least)."""
    return (QT + N) * (Dh + 8) * 2 + QT * (max(N, Dh) + 4) * 4 + QT * (N + 8) * 2


def _core_bwd_smem(N: int, Dh: int) -> int:
    """Shared memory of the one-block backward core (Q, K, V, dO, fp32 P and dP)."""
    return 4 * N * (Dh + 8) * 2 + 2 * N * (max(N, Dh) + 4) * 4 + N * (N + 8) * 2


def _bwd_tiled_smem(N: int, Dh: int) -> int:
    """The larger of the two backward passes' shared memory at their least
    tiles (16 query rows; 16 key and 16 query rows)."""
    rows = (32 + N) * (Dh + 8) * 2 + 32 * (max(N, Dh) + 4) * 4 + 16 * (N + 8) * 2
    cols = 64 * (Dh + 8) * 2 + (2 * 16 * 20 + 2 * 16 * (Dh + 4) + 48) * 4 + 16 * 24 * 2
    return max(rows, cols)


def _single_block_bwd(N: int, Dh: int) -> bool:
    return N <= _SINGLE_MAX_TOKENS and _core_bwd_smem(N, Dh) <= _MAX_SMEM


def supported_tokens(N: int, Dh: int) -> bool:
    """Whether K2f's attention cores take N tokens of head width Dh."""
    return (N % 16 == 0 and 16 <= N <= MAX_TOKENS and Dh % 16 == 0
            and _core_smem(N, Dh) <= _MAX_SMEM)


def supported_tokens_bwd(N: int, Dh: int) -> bool:
    """Whether K2b's (and K4's) attention core backwards take N tokens of
    head width Dh."""
    return supported_tokens(N, Dh) and (_single_block_bwd(N, Dh)
                                        or _bwd_tiled_smem(N, Dh) <= _MAX_SMEM)


def _check(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, kernel="K2"):
    """Shapes and types the half-block kernels take around K2's attention
    core or K8's (whose token counts :func:`fused_attention_block` picked)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} takes bf16 activations, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{kernel} takes (B, N, D) tokens, got shape {tuple(x.shape)}")
    B, N, D = x.shape
    if D % H:
        raise ValueError(f"D={D} is not divisible by H={H}")
    Dh = D // H
    if wqkv.shape != (3 * D, D) or wproj.shape != (D, D):
        raise ValueError(f"{kernel} weights must be (3D, D) and (D, D), got "
                         f"{tuple(wqkv.shape)} and {tuple(wproj.shape)}")
    for name, v, n in (("scale", scale_p, D), ("bias", bias_p, D),
                       ("bqkv", bqkv, 3 * D), ("bproj", bproj, D)):
        if v.shape != (n,):
            raise ValueError(f"{kernel} {name} must be ({n},), got {tuple(v.shape)}")
    if D % 64 or D > 1024:
        raise ValueError(f"{kernel} needs D a multiple of 64 and D <= 1024, got D={D}")
    if kernel == "K2" and not supported_tokens(N, Dh):
        raise ValueError(f"K2's attention cores do not take N={N}, Dh={Dh} "
                         f"(need multiples of 16, N <= {MAX_TOKENS})")
    if not x.is_contiguous():
        raise ValueError(f"{kernel} needs contiguous activations")


def _kernel_operands(scale_p, bias_p, wqkv, bqkv, wproj, bproj):
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return f32(scale_p), f32(bias_p), bf(wqkv), f32(bqkv), bf(wproj), f32(bproj)


def _fwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, core):
    """The LN-prologue qkv GEMM, ``core(qkv) -> (att, saved)`` on its
    (B, N, 3D) output, and the projection GEMM with the residual:
    ``(out, att, saved)``."""
    B, N, D = x.shape
    s, bb, wqkv_b, bqkv_f, wproj_b, bproj_f = _kernel_operands(
        scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    x2 = x.reshape(B * N, D)
    qkv, _, _ = gemm.ln_gemm(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS)
    att, saved = core(qkv.view(B, N, 3 * D))
    out = gemm.gemm_residual(att.view(B * N, D), wproj_b, bproj_f, x2)
    return out.reshape(B, N, D), att, saved


def _bwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, dout, core_bwd):
    """The half-block backward around an attention core: the qkv GEMM
    recomputed (it also gives y = bf16(LN(x)) for dWqkv), datt,
    ``core_bwd(qkv, datt) -> (att (B, N, D), dqkv (B, N, 3D))``, dWproj and
    dbproj, then dWqkv, dbqkv, dy and the LN backward with the residual."""
    B, N, D = x.shape
    if dout.shape != x.shape:
        raise ValueError(f"the cotangent must be {tuple(x.shape)}, got {tuple(dout.shape)}")
    s, bb, wqkv_b, bqkv_f, wproj_b, _ = _kernel_operands(
        scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    x2 = x.reshape(B * N, D)
    dob = dout.to(torch.bfloat16).contiguous().reshape(B * N, D)
    qkv, _, y = gemm.ln_gemm(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS, with_y=True)
    datt = gemm.gemm_nn(dob, wproj_b, gemm.NN_BF16).view(B, N, D)
    att, dqkv = core_bwd(qkv.view(B, N, 3 * D), datt)
    del qkv, datt
    dwproj, dbproj = gemm.gemm_tn(dob, att.view(B * N, D), with_colsum=True)
    del att
    dqkv = dqkv.view(B * N, 3 * D)
    dwqkv, dbqkv = gemm.gemm_tn(dqkv, y, with_colsum=True)
    dy = gemm.gemm_nn(dqkv, wqkv_b, gemm.NN_F32)
    del dqkv
    dx, dscale, dbias = gemm.ln_bwd(x2, dy, dob, s)
    return dx.reshape(B, N, D), dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


def _k2_core(qkv, H):
    """K2's attention core on a (B, N, 3D) qkv buffer -> (B, N, D) bf16."""
    B, N, D3 = qkv.shape
    Dh = D3 // 3 // H
    att = torch.empty((B, N, D3 // 3), dtype=torch.bfloat16, device=qkv.device)
    check_status(load_library().ddm_attention_core(
        qkv.data_ptr(), att.data_ptr(), B, N, H, Dh, Dh ** -0.5, current_stream(qkv.device)),
        "K2 attention_core")
    return att


def _core_bwd_att(qkv, datt, H, tiled=None):
    """K2b's and K4's attention core -> (att (B, N, D), dqkv (B, N, 3D)),
    bf16: one block per (image, head) where it fits, else the two passes
    (``tiled`` forces the choice)."""
    B, N, D3 = qkv.shape
    Dh = D3 // 3 // H
    if tiled is None:
        tiled = not _single_block_bwd(N, Dh)
    att = torch.empty((B, N, D3 // 3), dtype=torch.bfloat16, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    stream = current_stream(qkv.device)
    if tiled:
        stats = torch.empty((B, H, N, 3), dtype=torch.float32, device=qkv.device)
        check_status(load_library().ddm_attention_core_bwd_tiled(
            qkv.data_ptr(), datt.data_ptr(), att.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            B, N, H, Dh, Dh ** -0.5, stream), "attention_core_bwd_tiled")
    else:
        check_status(load_library().ddm_attention_core_bwd_att(
            qkv.data_ptr(), datt.data_ptr(), att.data_ptr(), dqkv.data_ptr(), B, N, H, Dh,
            Dh ** -0.5, stream), "attention_core_bwd_att")
    return att, dqkv


def _k2f(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H):
    out, _, _ = _fwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj,
                           lambda qkv: (_k2_core(qkv, H), None))
    LAUNCHES.add()
    return out


def _check_core_bwd(x, H, name):
    N, Dh = x.shape[1], x.shape[2] // H
    if not supported_tokens_bwd(N, Dh):
        raise ValueError(f"{name}'s attention core backwards do not take N={N}, Dh={Dh} "
                         "(their shared-memory tiles exceed the card's 227 KB)")


def _k2b(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, dout, counter=BWD_LAUNCHES):
    """The half-block backward on the card. K2b and K4 (the JAX ladder's
    fused and split backwards) run this one chain; ``counter`` says which
    tier the ladder picked."""
    _check_core_bwd(x, H, counter.name)
    grads = _bwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, dout,
                       lambda qkv, datt: _core_bwd_att(qkv, datt, H))
    counter.add()
    return grads


def _tier(x, H):
    """The JAX ladder's tier for these tokens; raises where it has none."""
    B, N, D = x.shape
    tier = tiers.attention_tier(B, N, D, H)
    if tier is None:
        raise tiers.no_kernel("the attention half-block", f"(B={B}, N={N}, D={D}, H={H})")
    return tier


def attention_block_bwd(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, dout):
    """The gradients of :func:`fused_attention_block` for the cotangent
    ``dout``: on CUDA tensors K2b or K4 by the JAX ladder's tier (or raise),
    on CPU tensors :func:`attention_block_bwd_reference`."""
    args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    if not uses_kernel(*args, dout):
        return attention_block_bwd_reference(*args, H, dout)
    _check(*args, H)
    counter = SPLIT_BWD_LAUNCHES if _tier(x, H) == "split" else BWD_LAUNCHES
    return _k2b(*args, H, dout, counter)


class _AttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H):
        ctx.save_for_backward(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
        ctx.heads = H
        args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
        if not uses_kernel(*args):
            return attention_block_reference(*args, H)
        _check(*args, H)
        _tier(x, H)
        return _k2f(*args, H)

    @staticmethod
    def backward(ctx, dout):
        args = ctx.saved_tensors
        grads = attention_block_bwd(*args, ctx.heads, dout)
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None,)


def _k8_core(qkv, H):
    """K8f reading q, k and v in place from the (B, N, 3D) qkv buffer."""
    D = qkv.shape[-1] // 3
    return flash.launch_k8f(*qkv.split(D, dim=-1), H, (D // H) ** -0.5)


def _k8_core_bwd(qkv, datt, att, lse, H):
    D = qkv.shape[-1] // 3
    return flash.launch_k8b(*qkv.split(D, dim=-1), att, lse, datt, H, (D // H) ** -0.5)


class _LongAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H):
        ctx.heads = H
        args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
        if not uses_kernel(*args):
            ctx.save_for_backward(*args)
            return long_attention_block_reference(*args, H)
        _check(*args, H, kernel="K8")
        out, att, lse = _fwd_chain(*args, lambda qkv: _k8_core(qkv, H))
        ctx.save_for_backward(*args, att, lse)  # no recompute of the core, as JAX's VJP
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        args, H = saved[:7], ctx.heads
        if uses_kernel(*args, dout):
            att, lse = saved[7:]
            grads = _bwd_chain(*args, dout,
                               lambda qkv, datt: (att, _k8_core_bwd(qkv, datt, att, lse, H)))
        else:
            grads = long_attention_block_bwd_reference(*args, H, dout)
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None,)


def fused_attention_block(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int):
    """``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens, with its backward.

    The token count picks the path, as the JAX ladder's shape gates do:
    N <= 512 takes K2f and, by :func:`ddm_tpu_torch.ops.tiers.attention_tier`,
    K2b or K4 (:func:`attention_block_reference` and
    :func:`attention_block_bwd_reference` on CPU tensors); N >= 1024 with
    Dh = 64 takes the long-sequence half-block around K8
    (:func:`long_attention_block_reference` and
    :func:`long_attention_block_bwd_reference` on CPU tensors); any other N
    raises. CUDA tensors launch the kernels (bf16 activations, fp32 LN
    params and biases, weights cast to bf16) or raise.
    """
    N, D = x.shape[-2:]
    Dh = D // H
    if N <= MAX_TOKENS:
        return _AttentionBlock.apply(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H)
    if flash.flash_supported(N, Dh):
        return _LongAttentionBlock.apply(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H)
    raise NotImplementedError(
        f"N={N} tokens of head width {Dh}: K2 takes N <= {MAX_TOKENS} and the flash tier "
        f"N >= {flash.MIN_TOKENS} with Dh = {flash.HEAD_DIM}; the JAX package runs K8 there "
        "(its flash tier takes other N and Dh), which the port does not take yet: ROADMAP.md "
        "Queue 1 item 9 (long sequences)")
