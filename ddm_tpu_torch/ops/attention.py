"""Attention half-block ``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens.

Port of ``ddm_tpu/ops/attention.py`` (the half-block and its backward).
:func:`fused_attention_block` is a ``torch.autograd.Function``. On CUDA
tensors its forward launches kernel K2f, three hand-written CUDA kernels: an
LN-prologue qkv product with a ``+ bqkv`` epilogue, the attention core
(``csrc/attention.cu``), and the projection product with a ``x + (acc +
bproj)`` epilogue, the two products ``wgmma`` fed by a TMA ring
(``csrc/gemm_wg.cu``, K1's kernel with epilogues of their own). It saves
only its inputs, and its backward recomputes the qkv product (the same
kernel and plan: the forward's bits), runs one attention core backward that
writes the attention output beside dq, dk and dv, and the datt, dWproj,
dWqkv and dy products on the same ring (the weight gradients split over the
rows in fixed ranges), then the LayerNorm backward (``csrc/gemm_bwd.cu``).
On CPU tensors the same Function runs the plain versions,
:func:`attention_block_reference` and :func:`attention_block_bwd_reference`.

The cores take every shape the JAX gates send them: 16 <= N <= 512 (N a
multiple of 16, the JAX gate's N <= 512) and any head width Dh a multiple
of 8 (the JAX gate's ``Dh % 8 == 0``: DiT-XL's Dh 72, DiT-S at ``--heads
16``'s Dh 24, DiT-S/4 at ``--heads 1``'s 384 at 64 px, up to 3712 at N =
16), each head's tile padded in shared memory to the next multiple of 16
with zero columns; other shapes raise ``NotImplementedError``. The
half-block products run D a multiple of 64 up to
:data:`ddm_tpu_torch.ops.gemm.LN_GEMM_MAX_K` (1344), the widths of every JAX
attention half-block tier.
The forward core has three designs. Where the head, padded to a multiple of
16, is at most 896 wide (every shape a DiT path sends) the plan takes the
registers design. Up to 128 columns: 64 query rows a block (128 past N 128
where they divide N), Q held as tensor-core fragments, K and V streamed
through a two-stage copy ring, and the scores, probabilities and output
kept in registers, with the softmax still exact over the whole row (the
scores held where N <= 128, else a first sweep for each row's max and
sum). Past 128 (the few-head paths: DiT-S/4 and DiT-B/4 at ``--heads 1``,
DiT-L/4 at ``--heads 2``, DiT-B/4 at ``--heads 3``): 64 query rows a block
of 16 warps up to a padded 512 where their scores fit, else 32 rows on 8
warps, the four warps of a 16-row tile splitting the output's columns and
each score tile's keys, K and V through a four-stage ring of 64-key x
128-column chunks, the fp32 scores written once to shared memory and the
exact softmax run over the whole row there. Its sums run in another order
than the resident core's, so its bits are not the resident core's: the
card holds it to the plain version. The resident and streamed designs run one
block per (image, head, query tile) over full score rows in shared memory
(the plan's pick past a padded 896, and where forced). The
backward core has a registers design at padded widths up to 896
(:data:`BWD_DESIGNS` "registers", and "registers-fused" up to 128): P, dP,
dS and the gradients as tensor-core fragments in registers, with a dq side
and a dk/dv side (the transposed score tiles over the query tiles). Up to
128 columns the dq side takes two sweeps over the key tiles (each row's
max, sum and sum of e dP, then P, att, dS and dq), and at N <= 64 one block
per (image, head) does all of it (the fused design, the main path's). Past
128 (the few-head paths) the warps of a 16-row tile split the gradients'
columns, as in the forward: the dq side, 32 query rows a block (16 where
their scores do not fit), writes each row's fp32 scores and dP once to
shared memory and takes the softmax over the whole row there, then dS K;
att is the wide forward core's output; the dk/dv side (16 to 64 key rows a
block) is K8b's own at the wide widths. Elsewhere the backward core runs one block per
(image, head) where its fp32 P and dP tiles fit shared memory (N <= 112 at
Dh = 64), and past that two passes, over query tiles (P, att, dq and the
row terms) and over key tiles and output column chunks (dk, dv). The
forward core's earlier designs and each pass hold a whole head in shared
memory where it fits (the resident design) and otherwise pass it through
in 64-column chunks, keeping only the fp32 score rows whole (the streamed
design, past the card's 227 KB: DiT-S/4 at ``--heads 1`` and 64 px,
DiT-B/4 at ``--heads 1``, DiT-L/4 at ``--heads 2`` and 64 px); the library's plan
(:func:`core_plan`) picks, and ``design=``
forces one for the card tests. Every design keeps the same rounding plan;
the resident and streamed designs and the backward's earlier ones keep the
same order of every sum, so they agree bit for bit where two apply; the
registers designs sum in another order, and the card holds them to the
plain versions and to the earlier designs by the bf16 rule.

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

Where the JAX ladder has no half-block tier (``attention_tier`` is None:
DiT-L at N = 256, N > 512, D not a multiple of 128), it runs its third
rung (``ddm_tpu/ops/attention.py:959-962``): an XLA half-block around
``fused_attention``, whose core :func:`ddm_tpu_torch.ops.tiers.core_tier`
picks. The port runs one Function there, :class:`_Rung3Block`: the same
wgmma qkv product, that core, and the projection product with the residual,
and K2b's backward chain around the core's backward; where those products
do not run D (D % 64 != 0, or past ``gemm.LN_GEMM_MAX_K``: DiT at
``--embed-dim 480``, 1472, 1536 or 1600), plain torch products with
:func:`rung3_block_reference`'s rounding around the same core, as JAX
computes them in XLA. The cores:

- K7 (``_fused_fwd_call`` / ``_fused_bwd``), the standalone attention core:
  K7f is K2f's query-tile core reading q, k and v as three operands of one
  row stride (:func:`launch_k7f`); K7b is K2b's core backward writing dq, dk
  and dv and no att (:func:`launch_k7b`). Their plain versions are
  :func:`attention_reference` and :func:`attention_core_bwd_reference`;
- K8, the online-softmax core for N >= 1024 (:mod:`ddm_tpu_torch.ops.flash`);
- none (XLA's ``attention_reference`` in the JAX package): the plain core,
  on the card too.

:func:`fused_attention` is ``fused_attention`` of ``ddm_tpu/ops/attention.py:248``
alone, differentiable over three (B, N, H*Dh) tensors q, k and v (the
tensor-parallel half-block's three column-parallel products, never packed
into one buffer): the same core, K7f/K7b (read in place, one row stride
each), K8, or the plain core on the device.

The forward saves ``(x, att)``, and K8's ``lse``, as JAX's custom VJPs save
their outputs, so the backward recomputes the qkv GEMM but not the
attention output that the projection's weight gradient reads. The weight
gradients stay fp32, where JAX's XLA autodiff of rung 3 rounds them to bf16
(the VJP of the weights' bf16 cast).
"""

from __future__ import annotations

import ctypes

import torch

from . import flash, gemm, tiers
from .kernel_config import (
    LaunchCounter,
    check_status,
    current_stream,
    design_code,
    load_library,
    uses_kernel,
)
from .mlp_block import layer_norm, layer_norm_bwd, ln_stats, matmul_f32

__all__ = [
    "attention_reference",
    "attention_block_reference",
    "attention_core_bwd_reference",
    "attention_core_bwd_att_reference",
    "attention_core_fwd",
    "attention_core_bwd",
    "attention_block_bwd",
    "attention_block_bwd_reference",
    "rung3_block_reference",
    "rung3_block_bwd_reference",
    "launch_k7f",
    "launch_k7b",
    "fused_attention",
    "fused_attention_block",
    "supported_tokens",
    "core_plan",
    "kernel_attrs",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "SPLIT_BWD_LAUNCHES",
    "CORE_LAUNCHES",
    "CORE_BWD_LAUNCHES",
    "MAX_TOKENS",
]

LAUNCHES = LaunchCounter("K2f")
BWD_LAUNCHES = LaunchCounter("K2b")
SPLIT_BWD_LAUNCHES = LaunchCounter("K4")
CORE_LAUNCHES = LaunchCounter("K7f")
CORE_BWD_LAUNCHES = LaunchCounter("K7b")
MAX_TOKENS = 512  # the JAX gate's N <= 512; the flash tier takes N >= 1024
# the cores' designs (``design=``), in the order of the library's codes
FWD_DESIGNS = ("resident", "streamed", "registers")
BWD_DESIGNS = ("one-block", "two-pass", "streamed", "registers", "registers-fused")
# the padded head widths both registers designs are built for (padded(Dh) <=
# 128), and the forward's wide registers instances past them: padded widths
# (up to 896) and query rows a block (32 on 8 warps; 64 on 16, up to 512);
# the backward's wide instances are one a count of 128-column chunks (2-7)
REGISTERS_WIDTHS = tuple(range(16, 129, 16))
WIDE_REGISTERS = tuple((dp, 32) for dp in range(256, 897, 128)) + tuple(
    (dp, 64) for dp in range(256, 513, 128))
# the core kernels whose registers and spills kernel_attrs reads
CORE_KERNELS = ("forward", "forward streamed", "one-block backward", "pass 1",
                "pass 1 streamed", "pass 2", "pass 2 streamed") + tuple(
    f"forward registers {dp} {kind}" for dp in REGISTERS_WIDTHS
    for kind in ("held", "two sweeps", "two sweeps 8 warps")) + tuple(
    f"backward registers {dp} {kind}" for dp in REGISTERS_WIDTHS
    for kind in ("dq att", "dq", "dk dv", "fused att", "fused")) + tuple(
    f"forward registers {dp - 112}-{dp} {rows} rows" for dp, rows in WIDE_REGISTERS) + tuple(
    f"backward registers {dp - 112}-{dp} {side}" for side in ("dq", "dk dv")
    for dp in range(256, 897, 128))


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


def _core_bwd(q, k, v, datt, H: int, with_att: bool):
    dtype = q.dtype
    scale = (q.shape[-1] // H) ** -0.5
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    q, k, v, datt = (_heads(t, H) for t in (q, k, v, datt.to(dtype)))
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    pb = rnd(p)
    att = (pb @ v).to(dtype) if with_att else None
    dv = (pb.transpose(-1, -2) @ datt).to(dtype)
    dp = datt @ v.transpose(-1, -2)
    ds = rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale)
    grads = ((ds @ k).to(dtype), (ds.transpose(-1, -2) @ q).to(dtype), dv)
    return tuple(_merge_heads(t) for t in ((att,) if with_att else ()) + grads)


def attention_core_bwd_att_reference(q, k, v, datt, H: int):
    """Plain version of K2b's and K4's attention core: ``(att, dq, dk, dv)``, all (B, N, D) in the compute
    dtype, from one fp32 P per (image, head): att = bf16(bf16(P) V),
    dv = bf16(bf16(P)^T datt), dS = bf16(scale * P * (dP - rowsum(P dP)))
    with dP = datt V^T in fp32, dq = bf16(dS K), dk = bf16(dS^T Q)."""
    return _core_bwd(q, k, v, datt, H, True)


def attention_core_bwd_reference(q, k, v, do, H: int):
    """Plain version of K7b, the standalone core's backward (``_bwd_kernel``):
    ``(dq, dk, dv)`` for the cotangent ``do`` of :func:`attention_reference`,
    by the rounding plan of :func:`attention_core_bwd_att_reference`."""
    return _core_bwd(q, k, v, do, H, False)


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


def _plain_core_bwd(q, k, v, datt, H: int):
    return (attention_reference(q, k, v, H), *attention_core_bwd_reference(q, k, v, datt, H))


def rung3_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, core):
    """Plain version of the third rung's half-block around ``core`` (from
    :func:`ddm_tpu_torch.ops.tiers.core_tier`): the plain K8f core for
    ``"K8"``, else :func:`attention_reference` (K7f's plain version, and
    the plain core where the JAX package runs XLA's)."""
    return attention_block_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H,
                                     attention_fn=_flash_core if core == "K8" else
                                     attention_reference)


def rung3_block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, dout,
                              core):
    """Plain version of the third rung's backward: the half-block chain
    around the plain K8f/K8b core for ``"K8"`` (lse replay, dsum from the
    bf16 o), else around :func:`attention_core_bwd_reference`."""
    return _block_bwd_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, dout,
                                _flash_core_bwd if core == "K8" else _plain_core_bwd)


def supported_tokens(N: int, Dh: int) -> bool:
    """Whether the attention cores (K2f, K2b, K4, K7) take N tokens of head
    width Dh, forward and backward: every shape the JAX gates send them."""
    return N % 16 == 0 and 16 <= N <= MAX_TOKENS and Dh % 8 == 0 and Dh > 0


def core_plan(N: int, Dh: int, backward: bool = False, design=None) -> dict:
    """The tiles the card's launchers take for N tokens of head width Dh,
    read from the library (the card's only; it builds the kernels): the
    forward's ``{"design", "QT", "C"}`` (C: the column chunk, the padded
    Dh where the design is resident or registers; for the registers design
    QT is the block's query rows: at a padded Dh up to 128, 64, or 128 past
    N 128 where they divide N; past it 64 or 32), the backward's ``{"design",
    "rows": (QT, C), "cols": (KT, QT, C, C2)}`` (pass 2's output column
    chunk C2; no pass tiles for the one-block design; for the registers
    designs the dq side's query rows a block and the padded head, and the
    dk/dv side's key rows a block, query rows a stage and the padded head
    twice). ``design`` forces one
    of :data:`FWD_DESIGNS` or :data:`BWD_DESIGNS`; raises where it (or,
    with None, every design) does not take the shape."""
    plan = (ctypes.c_int * 7)()
    names = BWD_DESIGNS if backward else FWD_DESIGNS
    check_status(load_library().ddm_attention_core_plan(
        N, Dh, int(backward), design_code(design, names), ctypes.addressof(plan)),
        f"attention core plan at N={N}, Dh={Dh}, design={design}")
    if not backward:
        return {"design": FWD_DESIGNS[plan[0]], "QT": plan[1], "C": plan[2]}
    return {"design": BWD_DESIGNS[plan[0]], "rows": tuple(plan[1:3]), "cols": tuple(plan[3:7])}


def kernel_attrs() -> dict:
    """Registers and local (spill) bytes a thread of each core kernel takes
    on the card: ``{name: {"registers", "local_bytes"}}`` over
    :data:`CORE_KERNELS`."""
    attrs = (ctypes.c_int * (2 * len(CORE_KERNELS)))()
    check_status(load_library().ddm_attention_kernel_attrs(ctypes.addressof(attrs)),
                 "attention kernel attributes")
    return {name: {"registers": attrs[2 * i], "local_bytes": attrs[2 * i + 1]}
            for i, name in enumerate(CORE_KERNELS)}


def _check(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, kernel="K2"):
    """Shapes and types the half-block kernels take around K2's attention
    core or the third rung's (:func:`fused_attention_block` picked which)."""
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
    if D % 64:
        raise ValueError(f"{kernel} needs D a multiple of 64, got D={D}")
    gemm.refuse_wide(D, kernel)
    if kernel == "K2" and not supported_tokens(N, Dh):
        raise NotImplementedError(
            f"K2's attention cores take N a multiple of 16 up to {MAX_TOKENS} (every square "
            f"token count the JAX gate's N % 8 == 0 admits) and Dh a multiple of 8; got N={N}, "
            f"Dh={Dh}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel} needs contiguous activations")


def _kernel_operands(scale_p, bias_p, wqkv, bqkv, wproj, bproj):
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    f32 = lambda t: t.float().contiguous()  # noqa: E731
    return f32(scale_p), f32(bias_p), bf(wqkv), f32(bqkv), bf(wproj), f32(bproj)


def _fwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, core):
    """The LN-prologue qkv product, ``core(qkv) -> (att, saved)`` on its
    (B, N, 3D) output, and the projection product with the residual, both
    on the wgmma TMA ring (``csrc/gemm_wg.cu``): ``(out, att, saved)``."""
    B, N, D = x.shape
    s, bb, wqkv_b, bqkv_f, wproj_b, bproj_f = _kernel_operands(
        scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    x2 = x.reshape(B * N, D)
    qkv, _, _ = gemm.ln_gemm_wg(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS)
    att, saved = core(qkv.view(B, N, 3 * D))
    out = gemm.gemm_residual_wg(att.view(B * N, D), wproj_b, bproj_f, x2)
    return out.reshape(B, N, D), att, saved


def _bwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, dout, core_bwd):
    """The half-block backward around an attention core, its products on the
    wgmma TMA ring (``csrc/gemm_wg.cu``): the qkv product recomputed (the
    forward's kernel and plan, so its bits; it also gives y = bf16(LN(x))
    for dWqkv), datt, ``core_bwd(qkv, datt) -> (att (B, N, D), dqkv (B, N,
    3D))``, dWproj and dbproj, then dWqkv, dbqkv, dy and the LN backward
    with the residual. The weight gradients split T in fixed row ranges,
    summed in a fixed order: a second call is bit-identical."""
    B, N, D = x.shape
    if dout.shape != x.shape:
        raise ValueError(f"the cotangent must be {tuple(x.shape)}, got {tuple(dout.shape)}")
    s, bb, wqkv_b, bqkv_f, wproj_b, _ = _kernel_operands(
        scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    x2 = x.reshape(B * N, D)
    dob = dout.to(torch.bfloat16).contiguous().reshape(B * N, D)
    qkv, _, y = gemm.ln_gemm_wg(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS, with_y=True)
    datt = gemm.expert_nn_wg(dob, wproj_b, gemm.NN_BF16).view(B, N, D)
    att, dqkv = core_bwd(qkv.view(B, N, 3 * D), datt)
    del qkv, datt
    dwproj, dbproj = gemm.expert_tn_wg(dob, att.view(B * N, D), with_colsum=True)
    del att
    dqkv = dqkv.view(B * N, 3 * D)
    dwqkv, dbqkv = gemm.expert_tn_wg(dqkv, y, with_colsum=True)
    dy = gemm.expert_nn_wg(dqkv, wqkv_b, gemm.NN_F32)
    del dqkv
    dx, dscale, dbias = gemm.ln_bwd(x2, dy, dob, s)
    return dx.reshape(B, N, D), dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


def _launch_core(q, k, v, H, design=None):
    """The forward core on CUDA tensors its caller has checked -> (B, N, D)
    bf16, q, k and v read in place where they share one row stride (the
    thirds of a qkv buffer): the registers design where the padded head is
    at most 896 wide, else resident where a head fits, else streamed
    (``design`` forces one of :data:`FWD_DESIGNS`)."""
    code = design_code(design, FWD_DESIGNS)
    q, k, v, ld = flash._qkv_rows(q, k, v)
    B, N, D = q.shape
    Dh = D // H
    out = torch.empty((B, N, D), dtype=torch.bfloat16, device=q.device)
    check_status(load_library().ddm_attention_core(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, out.data_ptr(), B, N, H, Dh, Dh ** -0.5,
        code, current_stream(q.device)), "attention_core")
    return out


def _launch_core_bwd(q, k, v, do, H, with_att, design=None):
    """The backward core -> ``(att or None, dqkv (B, N, 3D))``, bf16: the
    registers design where the padded head is at most 896 wide (one block
    per (image, head) at N <= 64 up to 128 columns), else one block per
    (image, head) where it fits, else the two passes, each resident or
    streamed (``design`` forces one of :data:`BWD_DESIGNS`)."""
    q, k, v, ld = flash._qkv_rows(q, k, v)
    B, N, D = q.shape
    Dh = D // H
    if do.shape != q.shape:
        raise ValueError(f"the core backward takes do of shape {tuple(q.shape)}, got "
                         f"{tuple(do.shape)}")
    do = flash._aligned(do.to(torch.bfloat16))
    passes = core_plan(N, Dh, True, design)["design"] != "one-block"
    empty = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device=q.device)  # noqa: E731
    att = empty(B, N, D) if with_att else None
    stats = empty(B, H, N, 3, dt=torch.float32) if passes else None
    dqkv = empty(B, N, 3 * D)
    check_status(load_library().ddm_attention_core_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, do.data_ptr(),
        None if att is None else att.data_ptr(), dqkv.data_ptr(),
        None if stats is None else stats.data_ptr(), B, N, H, Dh, Dh ** -0.5,
        design_code(design, BWD_DESIGNS), current_stream(q.device)), "attention_core_bwd")
    return att, dqkv


def _k2_core(qkv, H, design=None):
    """K2's attention core on a (B, N, 3D) qkv buffer -> (B, N, D) bf16
    (``design`` forces one of :data:`FWD_DESIGNS`)."""
    return _launch_core(*qkv.split(qkv.shape[-1] // 3, dim=-1), H, design)


def _core_bwd_att(qkv, datt, H, design=None):
    """K2b's and K4's attention core -> (att (B, N, D), dqkv (B, N, 3D)),
    bf16, by the plan of :func:`_launch_core_bwd` (``design`` forces one of
    :data:`BWD_DESIGNS`)."""
    return _launch_core_bwd(*qkv.split(qkv.shape[-1] // 3, dim=-1), datt, H, True, design)


def _k2f(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, design=None):
    """K2f's chain; ``design`` forces one of the core's :data:`FWD_DESIGNS`."""
    out, _, _ = _fwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj,
                           lambda qkv: (_k2_core(qkv, H, design), None))
    LAUNCHES.add()
    return out


def _k2b(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, dout, counter=BWD_LAUNCHES,
         design=None):
    """The half-block backward on the card. K2b and K4 (the JAX ladder's
    fused and split backwards) run this one chain; ``counter`` says which
    tier the ladder picked; ``design`` forces one of the core's
    :data:`BWD_DESIGNS`."""
    grads = _bwd_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, dout,
                       lambda qkv, datt: _core_bwd_att(qkv, datt, H, design))
    counter.add()
    return grads


def _tier(x, H):
    """The JAX ladder's half-block tier for these tokens; raises where it has
    none (:func:`fused_attention_block` runs the third rung there)."""
    B, N, D = x.shape
    tier = tiers.attention_tier(B, N, D, H)
    if tier is None:
        raise ValueError(f"the JAX ladder has no half-block tier at (B={B}, N={N}, D={D}, "
                         f"H={H}): K2b and K4 do not run there")
    return tier


def attention_block_bwd(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, dout):
    """The gradients of :func:`fused_attention_block` where the JAX ladder
    has a half-block tier, for the cotangent ``dout``: on CUDA tensors K2b or
    K4 by that tier, on CPU tensors :func:`attention_block_bwd_reference`."""
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
        return _k2f(*args, H)

    @staticmethod
    def backward(ctx, dout):
        args = ctx.saved_tensors
        grads = attention_block_bwd(*args, ctx.heads, dout)
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None,)


# --- the third rung: the standalone cores K7 and K8, or the plain core ---

def _check_core(q, k, v, H: int, core="K7") -> None:
    """Shapes and types the standalone cores take: bf16 (B, N, H*Dh) q, k and
    v of one shape, with N and Dh the port's ``core`` takes (``None``: the
    plain core, any)."""
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the attention cores take bf16 q, k and v, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"the attention cores take (B, N, H*Dh) q, k and v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, N, D = q.shape
    if D % H:
        raise ValueError(f"D={D} is not divisible by H={H}")
    _refuse_unported_core(core, N, D // H)


def _refuse_unported_core(core, N: int, Dh: int) -> None:
    """Raise where the JAX gate takes ``core`` and the port's kernel does not."""
    if core == "K7" and not supported_tokens(N, Dh):  # the port's K7 takes every such shape
        raise NotImplementedError(
            f"K7's cores take N a multiple of 16 up to {MAX_TOKENS} (every square token count "
            f"the JAX gate's N % 8 == 0 admits) and Dh a multiple of 8; got N={N}, Dh={Dh}")
    if core == "K8" and not flash.flash_supported(N, Dh):  # the port's K8 takes every such shape
        raise NotImplementedError(
            f"the JAX gate takes K8 at N={N}, Dh={Dh}; the port's K8 takes N a multiple of "
            f"{flash.TILE} and Dh in {flash.HEAD_DIMS}")


def launch_k7f(q, k, v, H: int) -> torch.Tensor:
    """K7f on CUDA tensors its caller has checked: the (B, N, D) bf16
    attention output, q, k and v read in place where they share one row
    stride (the thirds of a qkv buffer)."""
    out = _launch_core(q, k, v, H)
    CORE_LAUNCHES.add()
    return out


def launch_k7b(q, k, v, do, H: int, design=None) -> torch.Tensor:
    """K7b on CUDA tensors its caller has checked: dq, dk and dv as the
    thirds of one (B, N, 3D) bf16 buffer, and no att (``design`` forces one
    of :data:`BWD_DESIGNS`)."""
    _, dqkv = _launch_core_bwd(q, k, v, do, H, False, design)
    CORE_BWD_LAUNCHES.add()
    return dqkv


def attention_core_fwd(q, k, v, H: int) -> torch.Tensor:
    """The standalone core's forward over (B, N, H*Dh) q, k and v: K7f on
    CUDA tensors (or raise), :func:`attention_reference` on CPU tensors."""
    if not uses_kernel(q, k, v):
        return attention_reference(q, k, v, H)
    _check_core(q, k, v, H)
    return launch_k7f(q, k, v, H)


def attention_core_bwd(q, k, v, do, H: int):
    """``(dq, dk, dv)`` of the standalone core for the cotangent ``do``: K7b
    on CUDA tensors (or raise; the three are views into one (B, N, 3D)
    buffer), :func:`attention_core_bwd_reference` on CPU tensors."""
    if not uses_kernel(q, k, v, do):
        return attention_core_bwd_reference(q, k, v, do, H)
    _check_core(q, k, v, H)
    return launch_k7b(q, k, v, do, H).split(q.shape[2], dim=-1)


def _gemm_chain_takes(D: int) -> bool:
    """Whether the third rung runs the half-block's wgmma products (the
    LN-prologue qkv product and the projection with the residual) at width
    D: up to ``gemm.LN_GEMM_MAX_K``, as K2's chains; past it the plain
    products (JAX's XLA). Whether the chain should take those widths is
    ROADMAP item 12's question."""
    return D % 64 == 0 and D <= gemm.LN_GEMM_MAX_K


def _rung3_core(q, k, v, H: int, core):
    """The third rung's core on q, k and v (the thirds of one qkv buffer):
    ``(att, lse)``, lse for K8 only."""
    if core is not None:
        _check_core(q, k, v, H, core)
    if core == "K7":
        return launch_k7f(q, k, v, H), None
    if core == "K8":
        return flash.launch_k8f(q, k, v, H, (q.shape[-1] // H) ** -0.5)
    return attention_reference(q, k, v, H), None


def _rung3_core_bwd(q, k, v, datt, att, lse, H: int, core):
    """The core's backward: dq, dk and dv as one (B, N, 3D) buffer."""
    if core == "K7":
        return launch_k7b(q, k, v, datt, H)
    if core == "K8":
        return flash.launch_k8b(q, k, v, att, lse, datt, H, (q.shape[-1] // H) ** -0.5)
    return torch.cat(attention_core_bwd_reference(q, k, v, datt, H), dim=-1)


def _products_fwd(args, H: int, core):
    """The third rung where the half-block GEMMs do not take D: JAX's XLA
    LN, qkv and projection (:func:`attention_block_reference`, plain torch
    products) around the core: ``(out, att, lse)``."""
    held = []

    def attention_fn(q, k, v, H):
        held[:] = _rung3_core(q, k, v, H, core)
        return held[0]

    out = attention_block_reference(*args, H, attention_fn=attention_fn)
    return (out, *held)


class _Rung3Block(torch.autograd.Function):
    """The JAX ladder's third rung: the qkv GEMM, the core ``core``, the
    projection GEMM with the residual, and its backward around the core's.
    Where the GEMMs do not take D (D % 64 != 0 or past
    ``gemm.LN_GEMM_MAX_K``) the products around the core are plain torch
    ones with :func:`rung3_block_reference`'s rounding, forward and
    backward (:func:`rung3_block_bwd_reference`'s), as JAX runs them in XLA."""

    @staticmethod
    def forward(ctx, x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, core):
        ctx.heads, ctx.core = H, core
        args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
        if not uses_kernel(*args):
            ctx.save_for_backward(*args)
            return rung3_block_reference(*args, H, core)
        B, N, D = x.shape
        _refuse_unported_core(core, N, D // H)  # before any launch
        ctx.chain = _gemm_chain_takes(D)
        if ctx.chain:
            _check(*args, H, kernel="the third rung")
            out, att, lse = _fwd_chain(
                *args, lambda qkv: _rung3_core(*qkv.split(D, dim=-1), H, core))
        else:
            out, att, lse = _products_fwd(args, H, core)
        ctx.save_for_backward(*args, att, lse)  # no recompute of the core, as JAX's VJPs
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        args, H, core = saved[:7], ctx.heads, ctx.core
        D = args[0].shape[-1]
        if not uses_kernel(*args, dout):
            grads = rung3_block_bwd_reference(*args, H, dout, core)
        else:
            att, lse = saved[7:]

            def core_bwd(q, k, v, datt):
                return _rung3_core_bwd(q, k, v, datt, att, lse, H, core)

            if ctx.chain:
                grads = _bwd_chain(*args, dout, lambda qkv, datt: (
                    att, core_bwd(*qkv.split(D, dim=-1), datt)))
            else:
                grads = _block_bwd_reference(*args, H, dout, lambda q, k, v, datt, H: (
                    att, *core_bwd(q, k, v, datt).split(D, dim=-1)))
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None, None)


class _Attention(torch.autograd.Function):
    """The standalone core that ``tiers.core_tier`` picks, over q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, H, core):
        ctx.heads, ctx.core = H, core
        if not uses_kernel(q, k, v):
            ctx.save_for_backward(q, k, v)
            return _flash_core(q, k, v, H) if core == "K8" else attention_reference(q, k, v, H)
        _check_core(q, k, v, H, core)
        D = q.shape[-1]
        lse = None
        if core == "K7":
            o = launch_k7f(q, k, v, H)
        elif core == "K8":
            o, lse = flash.launch_k8f(q, k, v, H, (D // H) ** -0.5)
        else:
            o = attention_reference(q, k, v, H)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, *saved = ctx.saved_tensors
        H, core = ctx.heads, ctx.core
        D = q.shape[-1]
        if not uses_kernel(q, k, v, do):
            grads = (_flash_core_bwd(q, k, v, do, H)[1:] if core == "K8" else
                     attention_core_bwd_reference(q, k, v, do, H))
        elif core == "K7":
            grads = launch_k7b(q, k, v, do, H).split(D, dim=-1)
        elif core == "K8":
            o, lse = saved
            grads = flash.launch_k8b(q, k, v, o, lse, do, H, (D // H) ** -0.5).split(D, dim=-1)
        else:
            grads = attention_core_bwd_reference(q, k, v, do, H)
        return (*(g.to(t.dtype) for g, t in zip(grads, (q, k, v))), None, None)


def fused_attention(q, k, v, H: int):
    """Multi-head attention over (B, N, H*Dh) q, k and v, heads contiguous,
    with its backward: the core ``tiers.core_tier`` picks from the shapes,
    as JAX's ``fused_attention`` gates do. CUDA tensors launch K7f/K7b or
    K8f/K8b (bf16, or raise where the port lacks the kernel JAX would run),
    or run the plain core where JAX runs XLA's; CPU tensors take the plain
    versions (:func:`attention_reference` and
    :func:`attention_core_bwd_reference`, or K8's)."""
    B, N, D = q.shape
    if D % H:
        raise ValueError(f"D={D} is not divisible by H={H}")
    return _Attention.apply(q, k, v, H, tiers.core_tier(B, N, D, H))


def fused_attention_block(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int):
    """``x + proj(MHA(qkv(LN(x))))`` over (B, N, D) tokens, with its backward.

    The shapes pick the path, as the JAX ladder's gates do: where
    :func:`ddm_tpu_torch.ops.tiers.attention_tier` has a tier, K2f and K2b
    or K4 (:func:`attention_block_reference` and
    :func:`attention_block_bwd_reference` on CPU tensors); elsewhere the
    third rung around the core :func:`ddm_tpu_torch.ops.tiers.core_tier`
    picks, K7, K8 or the plain core (:func:`rung3_block_reference` and
    :func:`rung3_block_bwd_reference` on CPU tensors). CUDA tensors launch
    the kernels (bf16 activations, fp32 LN params and biases, weights cast
    to bf16) or raise where the port lacks the kernel JAX would run.
    """
    B, N, D = x.shape
    args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    if tiers.attention_tier(B, N, D, H) is not None:
        return _AttentionBlock.apply(*args, H)
    return _Rung3Block.apply(*args, H, tiers.core_tier(B, N, D, H))
