"""The attention half-block backward with single phases removed (X3), and
K1f with its GELU removed: a time-attribution experiment.

Port of ``tools/kbench_ablate.py``: ``run_bwd_variant`` (kernel
``_bwd_kernel_ablate``) and its MLP half, ``_fused_fwd_call`` timed with
``_gelu`` set to the identity. Each flag removes one phase of the attention
half-block's backward, so that the time each variant saves splits the
backward among its phases; a variant with a flag set computes something
else on purpose. The tool's eight variants are :data:`VARIANTS`.

On CUDA tensors :func:`attention_block_bwd_ablate` is K2b's chain
(``ops/attention.py`` ``_bwd_chain``) around X3's instances of the
one-block core backward (``csrc/attention.cu`` ``attention_core_bwd_kernel<SKIP>``,
compile-time flags; the all-off instance is the kernel K2b launches, so the
baseline is K2b bit for bit):

- ``skip_softmax``: P = S scale, rounded (the tool's ``probs = s * scale``),
  in place of the row softmax. The port's core computes one softmax and
  takes its P for att as well as for dv and dS, where the tool's r2 body
  recomputed att with a softmax of its own: so here att = bf16(bf16(S
  scale) V), and dWproj follows it;
- ``skip_ds``: dS = bf16(dP scale), without the rowsum(P dP) algebra;
- ``skip_core_mm``: S, P and att only, then dq = dk = dv = the head's datt;
- ``skip_recompute_mha``: no att = P V product, att = q;
- ``skip_ln``: dx = bf16(dout + dy), dscale = dbias = 0 (an instance of
  ``csrc/gemm_bwd.cu`` ``ln_bwd_kernel`` without the LN algebra);
- ``skip_dw``: the chain skips both weight-gradient products
  (``expert_tn_wg``) and returns zeros for dWproj, dbproj, dWqkv and dbqkv.

The TPU body packs g images under an all-zero mask (``kbench_ablate.py:199``),
so at g > 1 its queries attend across the images of a pack; the port works
per image, as K2b does, and computes the tool's function where g = 1 (odd
B, or N >= 256). :func:`attention_block_bwd_ablate_reference` is the plain
version, each flag removing the same step from
:func:`~ddm_tpu_torch.ops.attention.attention_block_bwd_reference`'s
arithmetic. :func:`mlp_block_fwd_identity_gelu` is K1f's chain (the wgmma
products of ``csrc/gemm_wg.cu``) with the first product's epilogue
``EPI_BIAS`` in place of ``EPI_GELU`` (the instance K2f's qkv product
launches: no new kernel). Nothing in ``models/`` calls this module;
``scripts/torch_kbench_ablate.py`` times it.
"""

from __future__ import annotations

import torch

from . import attention as A
from . import flash, gemm
from . import mlp_block as M
from .kernel_config import LaunchCounter, check_status, current_stream, load_library, uses_kernel

__all__ = [
    "attention_block_bwd_ablate",
    "attention_block_bwd_ablate_reference",
    "mlp_block_fwd_identity_gelu",
    "mlp_block_identity_gelu_reference",
    "ablate_takes",
    "core_code",
    "SKIPS",
    "VARIANTS",
    "LAUNCHES",
    "MLP_LAUNCHES",
]

LAUNCHES = LaunchCounter("X3b")
MLP_LAUNCHES = LaunchCounter("X3m")
SKIPS = ("skip_softmax", "skip_ds", "skip_ln", "skip_dw", "skip_core_mm", "skip_recompute_mha")
# the tool's variants (kbench_ablate.py:253-262), in its order
VARIANTS = (
    ("baseline", {}),
    ("no-softmax-vpu", {"skip_softmax": True}),
    ("no-ds-vpu", {"skip_ds": True}),
    ("no-ln-bwd", {"skip_ln": True}),
    ("no-dw-matmuls", {"skip_dw": True}),
    ("no-core-matmuls", {"skip_core_mm": True}),
    ("no-mha-recompute", {"skip_recompute_mha": True}),
    ("softmax+ds off", {"skip_softmax": True, "skip_ds": True}),
)
# the core's compile-time flags (csrc/attention.cu kSkip*) and the flag sets
# its instances take
_CORE_FLAGS = {"skip_softmax": 1, "skip_ds": 2, "skip_core_mm": 4, "skip_recompute_mha": 8}
_CORE_CODES = (0, 1, 2, 3, 4, 8)
MAX_TOKENS, MAX_HEAD = 64, 64  # within the one-block backward's (csrc/attention.cu one_block_fits)


def _skips(skips: dict) -> dict:
    unknown = sorted(set(skips) - set(SKIPS))
    if unknown:
        raise TypeError(f"X3 takes the flags {SKIPS}, got {unknown}")
    return {k: bool(skips.get(k, False)) for k in SKIPS}


def core_code(**skips) -> int:
    """The core instance's flag bits for ``skips``; raises for a set of core
    flags no instance takes (the tool's variants, one flag or softmax + dS)."""
    code = sum(bit for k, bit in _CORE_FLAGS.items() if _skips(skips)[k])
    if code not in _CORE_CODES:
        raise ValueError(f"X3's core instances take one core flag, or skip_softmax with "
                         f"skip_ds; got {skips}")
    return code


def ablate_takes(B: int, N: int, D: int, H: int) -> bool:
    """Whether X3 takes the shape: whole images of 16 <= N <= 64 tokens (N %
    16 == 0) and heads of Dh % 8 == 0 up to 64, where the one-block backward
    runs, at the half-block GEMMs' widths (D % 64 == 0 up to
    ``gemm.LN_GEMM_MAX_K``): DiT-S/4's and DiT-B/4's training shapes."""
    if B < 1 or H < 1 or D % H or N % 16 or not 16 <= N <= MAX_TOKENS:
        return False
    Dh = D // H
    return Dh % 8 == 0 and Dh <= MAX_HEAD and D % 64 == 0 and D <= gemm.LN_GEMM_MAX_K


def _refuse(x, H: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"X3 takes (B, N, D) tokens, got shape {tuple(x.shape)}")
    B, N, D = x.shape
    if not ablate_takes(B, N, D, H):
        raise NotImplementedError(
            f"X3, the attention-backward ablation, takes 16 <= N <= {MAX_TOKENS} tokens (N % 16 "
            f"== 0) and Dh % 8 == 0 up to {MAX_HEAD}, where the one-block backward runs, at D % "
            f"64 == 0 up to {gemm.LN_GEMM_MAX_K}; got (B={B}, N={N}, D={D}, H={H}). Other shapes "
            "are ROADMAP.md item 14's")


def _core_bwd_ablate_reference(q, k, v, datt, H: int, skip_softmax=False, skip_ds=False,
                               skip_core_mm=False, skip_recompute_mha=False):
    """K2b's plain core (``attention_core_bwd_att_reference``) with the
    flags' steps removed: ``(att, dq, dk, dv)``, (B, N, D) each."""
    dtype = q.dtype
    scale = (q.shape[-1] // H) ** -0.5
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    datt = datt.to(dtype)
    qh, kh, vh, dh = (A._heads(t, H) for t in (q, k, v, datt))
    s = qh @ kh.transpose(-1, -2)
    p = s * scale if skip_softmax else torch.softmax(s * scale, dim=-1)
    pb = rnd(p)
    att = q if skip_recompute_mha else A._merge_heads((pb @ vh).to(dtype))
    if skip_core_mm:
        return att, datt, datt, datt
    dv = (pb.transpose(-1, -2) @ dh).to(dtype)
    dp = dh @ vh.transpose(-1, -2)
    ds = rnd(dp * scale) if skip_ds else rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale)
    grads = ((ds @ kh).to(dtype), (ds.transpose(-1, -2) @ qh).to(dtype), dv)
    return (att, *(A._merge_heads(t) for t in grads))


def attention_block_bwd_ablate_reference(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int,
                                         dout, **skips):
    """Plain version of :func:`attention_block_bwd_ablate`:
    ``attention_block_bwd_reference``'s arithmetic with each flag's step
    removed (``skip_ln``: dx = dout + dy, dscale = dbias = 0; ``skip_dw``:
    zero weight and bias gradients; the core flags as
    :func:`_core_bwd_ablate_reference` says)."""
    sk = _skips(skips)
    B, N, D = x.shape
    dtype = x.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    xf = x.float().reshape(B * N, D)
    xhat, inv = M.ln_stats(xf)
    y = rnd(xhat * scale_p.float() + bias_p.float())
    qkv = (y @ rnd(wqkv).t() + bqkv.float()).to(dtype).reshape(B, N, 3 * D)
    q, k, v = qkv.split(D, dim=-1)
    do = dout.float().reshape(B * N, D)
    dob = rnd(do)
    datt = (dob @ rnd(wproj)).to(dtype).reshape(B, N, D)
    att, *dqkv = _core_bwd_ablate_reference(
        q, k, v, datt, H, **{f: sk[f] for f in _CORE_FLAGS})
    dqkv = torch.cat(dqkv, dim=-1).float().reshape(B * N, 3 * D)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=x.device)  # noqa: E731
    if sk["skip_dw"]:
        dwproj, dbproj, dwqkv, dbqkv = zeros(D, D), zeros(D), zeros(3 * D, D), zeros(3 * D)
    else:
        dwproj, dbproj = dob.t() @ att.float().reshape(B * N, D), do.sum(0)
        dwqkv, dbqkv = dqkv.t() @ y, dqkv.sum(0)
    dy = dqkv @ rnd(wqkv)
    if sk["skip_ln"]:
        dx, dscale, dbias = do + dy, zeros(D), zeros(D)
    else:
        dx, dscale, dbias = M.layer_norm_bwd(dy, xhat, inv, scale_p, do)
    return (dx.reshape(B, N, D).to(dtype), dscale, dbias, dwqkv, dbqkv, dwproj, dbproj)


def _launch_core(qkv, datt, H: int, code: int):
    """X3's core instance ``code`` on a (B, N, 3D) qkv buffer -> ``(att,
    dqkv)``, bf16."""
    q, k, v, ld = flash._qkv_rows(*qkv.split(qkv.shape[-1] // 3, dim=-1))
    B, N, D = q.shape
    datt = flash._aligned(datt)
    att = torch.empty((B, N, D), dtype=torch.bfloat16, device=q.device)
    dqkv = torch.empty((B, N, 3 * D), dtype=torch.bfloat16, device=q.device)
    check_status(load_library().ddm_attention_core_bwd_ablate(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, datt.data_ptr(), att.data_ptr(),
        dqkv.data_ptr(), B, N, H, D // H, (D // H) ** -0.5, code, current_stream(q.device)),
        f"X3 attention_core_bwd_ablate (flags {code})")
    return att, dqkv


def _ln_bwd_residual(dy, dres):
    """X3's LN backward without the algebra: bf16(dres + dy) over (T, D)."""
    T, D = dy.shape
    dx = torch.empty_like(dres)
    check_status(load_library().ddm_ln_bwd_residual(
        dy.data_ptr(), dres.data_ptr(), dx.data_ptr(), T, D, current_stream(dy.device)),
        "X3 ln_bwd_residual")
    return dx


def _ablate_chain(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H, dout, sk, code):
    """K2b's chain (``ops/attention.py`` ``_bwd_chain``: the same wgmma
    products, in its order) with X3's core instance and the chain's own
    removals."""
    B, N, D = x.shape
    s, bb, wqkv_b, bqkv_f, wproj_b, _ = A._kernel_operands(
        scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    x2 = x.reshape(B * N, D)
    dob = dout.to(torch.bfloat16).contiguous().reshape(B * N, D)
    qkv, _, y = gemm.ln_gemm_wg(x2, s, bb, wqkv_b, bqkv_f, gemm.EPI_BIAS,
                                with_y=not sk["skip_dw"])
    datt = gemm.expert_nn_wg(dob, wproj_b, gemm.NN_BF16).view(B, N, D)
    att, dqkv = _launch_core(qkv.view(B, N, 3 * D), datt, H, code)
    del qkv, datt
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=x.device)  # noqa: E731
    dqkv = dqkv.view(B * N, 3 * D)
    if sk["skip_dw"]:
        dwproj, dbproj, dwqkv, dbqkv = zeros(D, D), zeros(D), zeros(3 * D, D), zeros(3 * D)
    else:
        dwproj, dbproj = gemm.expert_tn_wg(dob, att.view(B * N, D), with_colsum=True)
        dwqkv, dbqkv = gemm.expert_tn_wg(dqkv, y, with_colsum=True)
    del att
    dy = gemm.expert_nn_wg(dqkv, wqkv_b, gemm.NN_F32)
    del dqkv
    if sk["skip_ln"]:
        dx, dscale, dbias = _ln_bwd_residual(dy, dob), zeros(D), zeros(D)
    else:
        dx, dscale, dbias = gemm.ln_bwd(x2, dy, dob, s)
    return dx.reshape(B, N, D), dscale, dbias, dwqkv, dbqkv, dwproj, dbproj


def attention_block_bwd_ablate(x, scale_p, bias_p, wqkv, bqkv, wproj, bproj, H: int, dout,
                               **skips):
    """The attention half-block's gradients ``(dx, dscale, dbias, dwqkv,
    dbqkv, dwproj, dbproj)`` for the cotangent ``dout``, with the phases the
    flags (:data:`SKIPS`) name removed: K2b's chain around X3's core instance
    on CUDA tensors (all flags off: K2b's gradients bit for bit),
    :func:`attention_block_bwd_ablate_reference` on CPU tensors. Shapes
    outside :func:`ablate_takes` raise on either device."""
    args = (x, scale_p, bias_p, wqkv, bqkv, wproj, bproj)
    sk = _skips(skips)
    code = core_code(**sk)
    _refuse(x, H)
    if not uses_kernel(*args, dout):
        return attention_block_bwd_ablate_reference(*args, H, dout, **sk)
    A._check(*args, H)
    if dout.shape != x.shape:
        raise ValueError(f"the cotangent must be {tuple(x.shape)}, got {tuple(dout.shape)}")
    grads = _ablate_chain(*args, H, dout, sk, code)
    LAUNCHES.add()
    return grads


def mlp_block_identity_gelu_reference(x, scale, bias, w1, b1, w2, b2):
    """Plain version of :func:`mlp_block_fwd_identity_gelu`:
    :func:`~ddm_tpu_torch.ops.mlp_block.mlp_block_reference` with the GELU
    the identity (h = LN(x) W1^T + b1 rounded as the GELU's output was)."""
    dtype = x.dtype
    xf = x.float()
    y = M.layer_norm(xf, scale, bias).to(dtype)
    h = (M.matmul_f32(y, w1, dtype) + b1.float()).to(dtype)
    out = M.matmul_f32(h, w2, dtype) + b2.float()
    return (xf + out).to(dtype)


def mlp_block_fwd_identity_gelu(x, scale, bias, w1, b1, w2, b2):
    """``x + (LN(x) W1^T + b1) W2^T + b2`` over (T, D) rows: K1f's wgmma
    chain with ``EPI_BIAS`` in place of ``EPI_GELU`` on CUDA tensors,
    :func:`mlp_block_identity_gelu_reference` on CPU tensors."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if not uses_kernel(*args):
        return mlp_block_identity_gelu_reference(*args)
    M._check(*args)
    s, bb, w1b, b1f, w2b, b2f = M._kernel_operands(scale, bias, w1, b1, w2, b2)
    hidden, _, _ = gemm.ln_gemm_wg(x, s, bb, w1b, b1f, gemm.EPI_BIAS)
    out = gemm.gemm_residual_wg(hidden, w2b, b2f, x)
    MLP_LAUNCHES.add()
    return out
