"""Online-softmax attention core for long sequences (kernel K8).

Port of ``ddm_tpu/ops/flash.py``. :func:`flash_attention` is a
``torch.autograd.Function`` over (B, N, H*Dh) inputs with heads contiguous
in the last axis. On CUDA tensors its forward launches K8f and its backward
K8b (``csrc/flash.cu``); on CPU tensors it runs the plain versions,
:func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`.

The forward returns ``o`` and saves ``lse = m + log(l)`` (fp32, (B, H, N));
the backward rebuilds the probabilities as ``exp(s - lse)``, so it needs no
second online pass. Numerics follow the TPU kernels: scores in fp32 and
then scaled by Dh^-0.5, ``p = exp(s - max)`` and ``l = sum(p)`` in fp32,
``o = bf16((bf16(p) v accumulated in fp32) / l)``; in the backward
``dsum = rowsum(fp32(do) fp32(o))`` from the saved rounded ``o``,
``dv = bf16(p)^T do``, ``dp = do v^T``, ``ds = bf16(p (dp - dsum) scale)``,
``dk = ds^T q``, ``dq = ds k``, each accumulated in fp32 and rounded once.
The TPU takes one k tile (bk = N) up to N = 2048, so its rounding of ``p``
is against the row max, as here; the CUDA kernel walks 64-key tiles and
rounds against the running max, which moves ``o`` by bf16 noise.

The kernels take every head width the JAX gate admits (its
``_heads_per_group`` takes 128 % Dh == 0 or Dh % 128 == 0, and its VMEM
budget no Dh past 896): Dh = 4, 8 and 16 (:data:`NARROW_DIMS`: one
instance of each kernel on 16-column tiles, zero-filled past Dh), 32, 64
(DiT-S, B and L) and 128, and 256 to 896 in steps of 128 (kernels that
walk a head in 128-column chunks); and N a multiple of 64. The TPU's
head-pair lane packing and phantom-head pad are 128-lane devices and are
not carried: any H runs as it is. Dh 1 and 2, which the gate's grouping
admits and its budget never does, raise ``NotImplementedError``.

K8f has two designs at every width (:data:`FWD_DESIGNS`): "registers", the
launcher's own pick, holds the scores, the probabilities, the output and
each row's running max and sum in registers as tensor-core fragments and
streams K and V through a copy ring (at Dh 4, 8 and 16 a warp holds two
16-row tiles over 64-key tiles, laid out for the exponential rate that
bounds it there; at Dh 32, 64 and 128 a warp holds Q and a 16-row tile's
whole output; at Dh 256 to 896, :data:`WIDE_DIMS`, two or four warps split
each 16-row tile's output columns and each score tile's keys, and K and V
pass through a ring of 64-key x 128-column chunks); "tiles", forced only,
stages them in shared memory (at the wide widths the 128-column chunked
kernel with its fp32 output in shared memory). Both follow the rounding
above element for element; the sums over a row's keys run in another
order, so their bits differ. K8b has the same two designs
(:data:`BWD_DESIGNS`): its "registers" design, the launcher's own pick,
keeps the score, dP, probability and dS tiles and the dq, dk and dv
accumulators in registers (the dk/dv kernel computes the transposed tiles,
keys by queries, so that P^T and dS^T feed its products as they stand),
with Q, dO, K and V through the same kind of ring
(``csrc/attention_bwd_regs.cuh``, shared with the attention core's
backward, at a padded width of 16 for the narrow heads; at the wide widths
two to eight warps split each 16-row tile's gradient columns and each
score tile's keys or queries, and the dk/dv kernel is the attention core's
own); "tiles", forced only, stages them in shared memory (at the wide
widths the 128-column chunked kernels with dq, dk and dv in shared
memory). dsum is the tiles design's bits in both.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel_config import (
    LaunchCounter,
    check_status,
    current_stream,
    design_code,
    load_library,
    uses_kernel,
)

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_reference",
    "flash_attention_bwd_reference",
    "flash_supported",
    "kernel_attrs",
    "launch_k8f",
    "launch_k8b",
    "FWD_LAUNCHES",
    "BWD_LAUNCHES",
    "HEAD_DIMS",
    "FWD_DESIGNS",
    "BWD_DESIGNS",
    "NARROW_DIMS",
    "REGISTERS_DIMS",
    "WIDE_DIMS",
    "TILE",
    "MIN_TOKENS",
]

FWD_LAUNCHES = LaunchCounter("K8f")
BWD_LAUNCHES = LaunchCounter("K8b")
# the head widths csrc/flash.cu is built for: every one the JAX gate admits
HEAD_DIMS = (4, 8, 16, 32, 64, 128, 256, 384, 512, 640, 768, 896)
# K8's designs (``design=``), in the order of the library's codes; the
# narrow widths, where each design is one instance on 16-column tiles (its
# ``kernel_attrs`` key carries Dh 16); the widths with an instance each up
# to 128; and the wide widths where K8f's and K8b's registers designs are
# the wide kernels and their tiles designs the 128-column chunked ones. The
# registers design is the launchers' pick at every width.
FWD_DESIGNS = ("tiles", "registers")
BWD_DESIGNS = ("tiles", "registers")
NARROW_DIMS = (4, 8, 16)
REGISTERS_DIMS = (32, 64, 128)
WIDE_DIMS = (256, 384, 512, 640, 768, 896)
TILE = 64         # q rows and k rows per tile of the kernels
MIN_TOKENS = 1024  # the JAX gate's long-sequence tier (ddm_tpu/ops/flash.py:286)


def flash_supported(N: int, Dh: int) -> bool:
    """Whether the port's K8 takes N tokens of head width Dh: N >= 1024 as
    the JAX gate has it, N a whole number of 64-row tiles, and a head width
    the kernels are built for."""
    return N >= MIN_TOKENS and N % TILE == 0 and Dh in HEAD_DIMS


def _heads(a: torch.Tensor, H: int) -> torch.Tensor:
    """(B, N, H*Dh) -> (B, H, N, Dh) in fp32."""
    B, N, D = a.shape
    return a.reshape(B, N, H, D // H).transpose(1, 2).float()


def _merge_heads(a: torch.Tensor) -> torch.Tensor:
    B, H, N, Dh = a.shape
    return a.transpose(1, 2).reshape(B, N, H * Dh)


def flash_attention_reference(q, k, v, H: int, scale=None):
    """Plain version of K8f: ``(o, lse)`` for (B, N, H*Dh) inputs, ``o`` in
    the inputs' dtype, ``lse`` fp32 (B, H, N). One head at a time, so the
    fp32 scores take (B, N, N) at once."""
    B, N, D = q.shape
    if scale is None:
        scale = (D // H) ** -0.5
    dtype = q.dtype
    outs, lses = [], []
    for qh, kh, vh in zip(*(_heads(t, H).unbind(1) for t in (q, k, v))):
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(dtype).float(), vh) / l
        outs.append(o.to(dtype))
        lses.append((m + torch.log(l)).squeeze(-1))
        del p
    return _merge_heads(torch.stack(outs, 1)), torch.stack(lses, 1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, H: int, scale=None):
    """Plain version of K8b: ``(dq, dk, dv)`` in the inputs' dtype for the
    cotangent ``do`` of ``o``, replaying the probabilities from ``lse`` as
    ``_bwd_kernel`` does (ddm_tpu/ops/flash.py:372-432)."""
    B, N, D = q.shape
    if scale is None:
        scale = (D // H) ** -0.5
    dtype = q.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    grads = []
    for qh, kh, vh, oh, doh, lh in zip(*(_heads(t, H).unbind(1) for t in (q, k, v, o)),
                                       _heads(do.to(dtype), H).unbind(1), lse.float().unbind(1)):
        dsum = (doh * oh).sum(-1, keepdim=True)
        p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale - lh[..., None])
        dv = torch.matmul(rnd(p).transpose(-1, -2), doh)
        ds = rnd(p * (torch.matmul(doh, vh.transpose(-1, -2)) - dsum) * scale)
        del p
        grads.append([t.to(dtype) for t in (torch.matmul(ds, kh),
                                            torch.matmul(ds.transpose(-1, -2), qh), dv)])
        del ds
    return tuple(_merge_heads(torch.stack(g, 1)) for g in zip(*grads))


def _check(q, k, v, H: int) -> None:
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K8 takes bf16 q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"K8 takes (B, N, H*Dh) q, k and v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, N, D = q.shape
    if D % H:
        raise ValueError(f"D={D} is not divisible by H={H}")
    if D // H not in HEAD_DIMS:
        raise NotImplementedError(
            f"K8 is built for the head widths the JAX gate admits, {HEAD_DIMS}; got Dh={D // H}")
    if N % TILE:
        raise ValueError(f"K8 needs N a multiple of {TILE}, got N={N}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _qkv_rows(q, k, v):
    """``(q, k, v, ld)``: the inputs as they are when each is (B, N, D) rows
    of one shared stride ``ld`` (e.g. the thirds of a (B, N, 3D)
    ``[q | k | v]`` buffer, read in place), else contiguous copies."""
    N, ld = q.shape[1], q.stride(1)
    if ld % 8 == 0 and all(t.stride(2) == 1 and t.stride(1) == ld and t.stride(0) == N * ld
                           and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        return q, k, v, ld
    return (*(_aligned(t) for t in (q, k, v)), q.shape[2])


def launch_k8f(q, k, v, H: int, scale: float, design=None):
    """K8f on CUDA tensors its caller has checked: ``(o, lse)``; ``design``
    forces one of :data:`FWD_DESIGNS` (the library raises where it does not
    take Dh)."""
    code = design_code(design, FWD_DESIGNS)
    q, k, v, ld = _qkv_rows(q, k, v)
    B, N, D = q.shape
    o = torch.empty((B, N, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    check_status(load_library().ddm_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, o.data_ptr(), lse.data_ptr(),
        B, N, H, D // H, scale, code, current_stream(q.device)), "K8f flash_fwd")
    FWD_LAUNCHES.add()
    return o, lse


def kernel_attrs() -> dict:
    """Registers and local (spill) bytes a thread of each K8 instance takes
    on the card: ``{(kernel, Dh): {"registers", "local_bytes"}}``, kernel a
    K8f design's name (its forward kernel), or ``"<design> dq"`` and
    ``"<design> dk dv"`` for K8b's two kernels, at Dh 32, 64 and 128, at
    :data:`WIDE_DIMS`, and at Dh 16 for the one instance that takes every
    width of :data:`NARROW_DIMS`."""
    fwd = lambda dims: [(d, dh) for d in FWD_DESIGNS[::-1] for dh in dims]  # noqa: E731
    bwd = lambda dims: [(f"{d} {side}", dh) for d in BWD_DESIGNS[::-1]  # noqa: E731
                        for side in ("dq", "dk dv") for dh in dims]
    keys = (fwd(REGISTERS_DIMS) + bwd(REGISTERS_DIMS) + fwd(WIDE_DIMS) + bwd(WIDE_DIMS)
            + fwd(NARROW_DIMS[-1:]) + bwd(NARROW_DIMS[-1:]))
    attrs = (ctypes.c_int * (2 * len(keys)))()
    check_status(load_library().ddm_flash_kernel_attrs(ctypes.addressof(attrs)),
                 "K8 kernel attributes")
    return {key: {"registers": attrs[2 * i], "local_bytes": attrs[2 * i + 1]}
            for i, key in enumerate(keys)}


def launch_k8b(q, k, v, o, lse, do, H: int, scale: float, design=None) -> torch.Tensor:
    """K8b on CUDA tensors its caller has checked: dq, dk and dv as the
    thirds of one (B, N, 3D) bf16 buffer; ``design`` forces one of
    :data:`BWD_DESIGNS` (the library raises where it does not take Dh)."""
    code = design_code(design, BWD_DESIGNS)
    q, k, v, ld = _qkv_rows(q, k, v)
    B, N, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (B, H, N):
        raise ValueError(f"K8b takes o and do of shape {tuple(q.shape)} and lse of shape "
                         f"{(B, H, N)}, got {tuple(o.shape)}, {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}")
    o, do = (_aligned(t.to(torch.bfloat16)) for t in (o, do))
    lse = lse.float().contiguous()
    dsum = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    dqkv = torch.empty((B, N, 3 * D), dtype=torch.bfloat16, device=q.device)
    check_status(load_library().ddm_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dqkv.data_ptr(), B, N, H, D // H, scale, code,
        current_stream(q.device)), "K8b flash_bwd")
    BWD_LAUNCHES.add()
    return dqkv


def flash_attention_fwd(q, k, v, H: int, scale=None):
    """``(o, lse)``: K8f on CUDA tensors (or raise), the plain version on CPU."""
    if scale is None:
        scale = (q.shape[-1] // H) ** -0.5
    if not uses_kernel(q, k, v):
        return flash_attention_reference(q, k, v, H, scale)
    _check(q, k, v, H)
    return launch_k8f(q, k, v, H, float(scale))


def flash_attention_bwd(q, k, v, o, lse, do, H: int, scale=None):
    """``(dq, dk, dv)``: K8b on CUDA tensors (or raise), the plain version on
    CPU. On CUDA the three are views into one (B, N, 3D) buffer."""
    if scale is None:
        scale = (q.shape[-1] // H) ** -0.5
    if not uses_kernel(q, k, v, o, lse, do):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, H, scale)
    _check(q, k, v, H)
    return launch_k8b(q, k, v, o, lse, do, H, float(scale)).split(q.shape[2], dim=-1)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, H, scale):
        o, lse = flash_attention_fwd(q, k, v, H, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.heads, ctx.scale = H, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.heads, ctx.scale), None, None)


def flash_attention(q, k, v, H: int, scale=None):
    """Multi-head attention over (B, N, H*Dh) inputs with its backward: CPU
    tensors take the plain versions, CUDA tensors launch K8f/K8b (bf16,
    Dh in :data:`HEAD_DIMS`, N >= 1024 a multiple of 64) or raise."""
    return _FlashAttention.apply(q, k, v, H, scale)
