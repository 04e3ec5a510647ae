"""Expert-batched GELU FFN of the MoE half-block (kernel K10).

Port of ``ddm_tpu/ops/expert_ffn.py``. Over per-expert slot rows
``x (E, S, D)``::

    out[e] = gelu(x[e] @ w1[e] + b1[e]) @ w2[e] + b2[e]

with the JAX layouts ``w1 (E, D, F)``, ``b1 (E, F)``, ``w2 (E, F, D)``,
``b2 (E, D)``. :func:`expert_ffn` is a ``torch.autograd.Function``. On CUDA
tensors its forward launches K10f, the batched NN GEMMs of
``csrc/gemm_bwd.cu`` with ``blockIdx.z`` as the expert (a bias + exact-erf
GELU epilogue, then a bias epilogue), or in a chunked tier k K10p on the
wgmma products of ``csrc/gemm_wg.cu`` (below); its backward launches K10b,
five wgmma products fed by a TMA ring on the expert coordinate of
``csrc/gemm_wg.cu`` (3-D maps, so a tile clips at its expert's last slot
row): the recompute of h as the TPU kernel does (bias + GELU + gelu'),
dW2 with db2 (split-K TN within each expert, fixed-order sums, db2 the
column sums of dO), dh (the dgelu epilogue with the db1 column sums), dW1,
and dx; the weights are read in both layouts in place, with no transposed
copy. On CPU tensors the same Function runs the plain versions,
:func:`expert_ffn_reference` and :func:`expert_ffn_bwd_reference`.

Numerics (both versions): bf16 matmul operands with fp32 accumulation;
GELU in fp32 with exact erf (with ``fast_gelu``, ``h sigmoid(1.702 h)`` as
in :mod:`ddm_tpu_torch.ops.mlp_block`: the epilogues' launch parameter and
the plain versions alike), rounded to the compute dtype; dW and the bias
gradients in fp32; dh rounded to bf16 for the products but db1 summed over
the unrounded dh; dx rounded to the compute dtype (``_bwd_kernel``).

Tiers (:func:`ddm_tpu_torch.ops.tiers.expert_tier`, the JAX ladder's
``expert_ffn_auto`` from the shapes): ``("fused", 1)`` (DiT-S widths) and
``("fwdonly", 1)`` run K10f; ``("fwdonly", k > 1)`` (D >= 768) runs the
forward as k partials K10p over column chunks of the hidden axis
(``_fwd_call_chunked`` -> ``_fwd_partial_kernel``): per chunk the wgmma
product on the expert coordinate with the bias + GELU epilogue (no gelu')
on the W1 column chunk, then the one on the W2 row chunk storing, then
adding into an fp32 (E, S, D) sum in chunk order, the last one rounding
``sum + b2`` once; both weight chunks are read in place. The backward of every tier is K10b's chain, the counterpart of the
JAX wide tier's XLA backward (which rounds the weight cotangents to bf16
where K10b keeps fp32). Where the ladder has no tier the JAX package runs
its jnp reference, and the port its plain versions, forward and backward,
on CUDA tensors too.
"""

from __future__ import annotations

import torch

from . import gemm, tiers
from .kernel_config import LaunchCounter, uses_kernel
from .mlp_block import _gelu_and_grad, gelu

__all__ = [
    "expert_ffn",
    "expert_ffn_reference",
    "expert_ffn_fchunked_reference",
    "expert_partial_reference",
    "expert_ffn_bwd",
    "expert_ffn_bwd_reference",
    "LAUNCHES",
    "BWD_LAUNCHES",
    "PARTIAL_LAUNCHES",
]

LAUNCHES = LaunchCounter("K10f")
BWD_LAUNCHES = LaunchCounter("K10b")
PARTIAL_LAUNCHES = LaunchCounter("K10p")  # one per hidden chunk


def _bmm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` per expert on operands rounded to ``dtype``, fp32 sums."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def expert_ffn_reference(x, w1, b1, w2, b2, fast_gelu: bool = False):
    """Plain PyTorch version of K10f over (E, S, D) slot rows in ``x.dtype``."""
    dtype = x.dtype
    h = _bmm(x, w1, dtype) + b1.float()[:, None, :]
    g = gelu(h, fast_gelu).to(dtype)
    return (_bmm(g, w2, dtype) + b2.float()[:, None, :]).to(dtype)


def _chunks(w1, b1, w2, k: int):
    """The k hidden-axis chunks ``(w1 columns, b1, w2 rows)``, as views."""
    fc = w1.shape[-1] // k
    return [(w1[:, :, c * fc:(c + 1) * fc], b1[:, c * fc:(c + 1) * fc],
             w2[:, c * fc:(c + 1) * fc]) for c in range(k)]


def expert_partial_reference(x, w1c, b1c, w2c, fast_gelu: bool = False):
    """Plain version of one K10p launch (``_fwd_partial_kernel``): per expert
    ``gelu(x w1c + b1c) w2c`` in fp32, for a chunk ``w1c (E, D, Fc)``,
    ``b1c (E, Fc)``, ``w2c (E, Fc, D)`` of the hidden axis."""
    dtype = x.dtype
    h = _bmm(x, w1c, dtype) + b1c.float()[:, None, :]
    g = gelu(h, fast_gelu).to(dtype)
    return _bmm(g, w2c, dtype)


def expert_ffn_fchunked_reference(x, w1, b1, w2, b2, k: int, fast_gelu: bool = False):
    """Plain version of K10p's chunked forward (``_fwd_call_chunked``): the
    k fp32 partials summed in chunk order, then ``sum + b2`` rounded once to
    ``x.dtype``."""
    acc = None
    for w1c, b1c, w2c in _chunks(w1, b1, w2, k):
        part = expert_partial_reference(x, w1c, b1c, w2c, fast_gelu)
        acc = part if acc is None else acc + part
    return (acc + b2.float()[:, None, :]).to(x.dtype)


def expert_ffn_bwd_reference(x, w1, b1, w2, b2, dout, fast_gelu: bool = False):
    """Plain PyTorch version of K10b: the gradients of :func:`expert_ffn`
    with respect to ``(x, w1, b1, w2, b2)`` for the cotangent ``dout``,
    following ``_bwd_kernel``'s rounding plan."""
    dtype = x.dtype
    rnd = lambda t: t.to(dtype).float()  # noqa: E731
    xf = rnd(x)
    h = xf @ rnd(w1) + b1.float()[:, None, :]
    gf, dfac = _gelu_and_grad(h, fast_gelu)
    g = rnd(gf)
    do = dout.float()
    dob = rnd(do)
    dw2 = g.transpose(1, 2) @ dob
    db2 = do.sum(1)
    dh = (dob @ rnd(w2).transpose(1, 2)) * dfac
    dhb = rnd(dh)
    dw1 = xf.transpose(1, 2) @ dhb
    db1 = dh.sum(1)
    dx = (dhb @ rnd(w1).transpose(1, 2)).to(dtype)
    return dx, dw1, db1, dw2, db2


def _check(x, w1, b1, w2, b2):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K10 takes bf16 slot rows, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"K10 takes (E, S, D) slot rows, got shape {tuple(x.shape)}")
    E, S, D = x.shape
    F = w1.shape[-1]
    if w1.shape != (E, D, F) or w2.shape != (E, F, D):
        raise ValueError(f"K10 weights must be (E, D, F) and (E, F, D), got "
                         f"{tuple(w1.shape)} and {tuple(w2.shape)}")
    if b1.shape != (E, F) or b2.shape != (E, D):
        raise ValueError(f"K10 biases must be (E, F) and (E, D), got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    if D % 64 or F % 64:
        raise ValueError(f"K10 needs D and F multiples of 64, got D={D}, F={F}")
    if not x.is_contiguous():
        raise ValueError("K10 needs contiguous slot rows")


def _k10f(x, w1, b1, w2, b2, fast_gelu=False):
    bf = torch.bfloat16
    g = gemm.gemm_nn(x, w1.to(bf).contiguous(), gemm.NN_BIAS_GELU,
                     bias=b1.float().contiguous(), fast_gelu=fast_gelu)
    out = gemm.gemm_nn(g, w2.to(bf).contiguous(), gemm.NN_BIAS, bias=b2.float().contiguous())
    LAUNCHES.add()
    return out


def _k10p(x, w1c, b1c, w2c, epi, acc, b2f=None, fast_gelu=False):
    """One hidden chunk on the wgmma ring's expert coordinate: the product
    with bias + GELU on the W1 column chunk, then the one on the W2 row
    chunk, both read in place, into the fp32 sum ``acc`` (``NN_F32`` stores,
    ``NN_ADD`` adds) or, for the last chunk, ``NN_FINAL_BIAS``."""
    g = gemm.expert_nn_wg(x, w1c, gemm.NN_BIAS_GELU, bias=b1c.contiguous(), fast_gelu=fast_gelu)
    out = gemm.expert_nn_wg(g, w2c, epi, bias=b2f if epi == gemm.NN_FINAL_BIAS else None,
                            acc=acc)
    PARTIAL_LAUNCHES.add()
    return out


def _k10p_chunked(x, w1, b1, w2, b2, k, fast_gelu=False):
    bf = torch.bfloat16
    acc = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    b2f = b2.float().contiguous()
    last = k - 1
    for c, (w1c, b1c, w2c) in enumerate(_chunks(w1.to(bf).contiguous(), b1.float(),
                                                w2.to(bf).contiguous(), k)):
        epi = gemm.NN_F32 if c == 0 else gemm.NN_FINAL_BIAS if c == last else gemm.NN_ADD
        out = _k10p(x, w1c, b1c, w2c, epi, acc, b2f, fast_gelu)
    return out


def _k10b(x, w1, b1, w2, b2, dout, fast_gelu=False):
    if dout.shape != x.shape:
        raise ValueError(f"K10b cotangent must be {tuple(x.shape)}, got {tuple(dout.shape)}")
    bf = torch.bfloat16
    w1b, w2b = w1.to(bf).contiguous(), w2.to(bf).contiguous()
    dob = dout.to(bf).contiguous()
    g, dfac = gemm.expert_nn_wg(x, w1b, gemm.NN_BIAS_GELU_GRAD, bias=b1.float().contiguous(),
                                fast_gelu=fast_gelu)
    dw2, db2 = gemm.expert_tn_wg(g, dob, with_colsum=True, colsum_of_b=True)
    del g
    # the dx-side products read w2[e] (F, D) and w1[e] (D, F) K-major: a . w^T
    dhb, db1 = gemm.expert_nn_wg(dob, w2b, gemm.NN_DGELU, dfac=dfac, transposed=True)
    del dfac
    dw1, _ = gemm.expert_tn_wg(x, dhb)
    dx = gemm.expert_nn_wg(dhb, w1b, gemm.NN_BF16, transposed=True)
    BWD_LAUNCHES.add()
    return dx, dw1, db1, dw2, db2


def expert_ffn_bwd(x, w1, b1, w2, b2, dout, fast_gelu: bool = False):
    """The gradients of :func:`expert_ffn` for the cotangent ``dout``: K10b on
    CUDA tensors (or raise), :func:`expert_ffn_bwd_reference` on CPU."""
    if not uses_kernel(x, w1, b1, w2, b2, dout):
        return expert_ffn_bwd_reference(x, w1, b1, w2, b2, dout, fast_gelu)
    _check(x, w1, b1, w2, b2)
    return _k10b(x, w1, b1, w2, b2, dout, fast_gelu)


class _ExpertFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, fast_gelu):
        args = (x, w1, b1, w2, b2)
        ctx.save_for_backward(*args)
        ctx.fast_gelu = fast_gelu
        E, S, D = x.shape
        F = w1.shape[-1]
        tier = tiers.expert_tier(E, S, D, F)
        chunks = tier[1] if tier is not None else 1
        ctx.plain = not uses_kernel(*args) or tier is None
        if ctx.plain:
            if chunks > 1:
                return expert_ffn_fchunked_reference(*args, chunks, fast_gelu)
            return expert_ffn_reference(*args, fast_gelu)
        _check(*args)
        if chunks > 1:
            return _k10p_chunked(*args, chunks, fast_gelu)
        return _k10f(*args, fast_gelu)

    @staticmethod
    def backward(ctx, dout):
        args = ctx.saved_tensors
        grads = (expert_ffn_bwd_reference(*args, dout, ctx.fast_gelu) if ctx.plain else
                 expert_ffn_bwd(*args, dout.contiguous(), ctx.fast_gelu))
        return tuple(g.to(a.dtype) for g, a in zip(grads, args)) + (None,)


def expert_ffn(x, w1, b1, w2, b2, fast_gelu: bool = False):
    """Per-expert GELU FFN ``(E, S, D) -> (E, S, D)`` with its backward.

    CPU tensors take :func:`expert_ffn_reference` (or, in a chunked tier,
    :func:`expert_ffn_fchunked_reference`) and
    :func:`expert_ffn_bwd_reference`; CUDA tensors launch K10f, or k K10p in
    a chunked tier, and K10b (bf16 slot rows, weights cast to bf16, fp32
    biases) or raise; where the JAX ladder has no tier, the plain versions on
    any device. ``fast_gelu`` takes the sigmoid GELU in every one of them.
    """
    return _ExpertFFN.apply(x, w1, b1, w2, b2, fast_gelu)
