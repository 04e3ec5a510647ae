"""ctypes launchers for the half-block GEMMs (``csrc/gemm.cu``,
``csrc/gemm_bwd.cu``), shared by the MLP, attention and expert-FFN wrappers.

Each function takes CUDA tensors that its caller has checked (bf16
activations and weights, fp32 biases and LN parameters, contiguous),
allocates its outputs and scratch with ``torch.empty`` on the same device,
launches on the current stream and raises if a launch was refused. They
count no launches: the half-block wrappers that call them do.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .kernel_config import check_status, current_stream, load_library

__all__ = ["ln_gemm", "gemm_residual", "gemm_partial", "gemm_nn", "gemm_tn", "ln_bwd",
           "cast_bf16", "tn_splits", "ln_gemm_smem", "refuse_wide", "LN_GEMM_MAX_K"]

# ln_gemm epilogues (csrc/gemm.cu LnGemmEpi)
EPI_BIAS, EPI_GELU, EPI_GELU_GRAD = 0, 1, 2
# gemm_partial epilogues (csrc/gemm.cu PartialEpi)
PART_STORE, PART_ADD, PART_FINAL_RES = 0, 1, 2
# gemm_nn epilogues (csrc/gemm_bwd.cu NNEpi)
NN_F32, NN_BF16, NN_DGELU, NN_BIAS, NN_BIAS_GELU, NN_BIAS_GELU_GRAD = 0, 1, 2, 3, 4, 5
NN_ADD, NN_FINAL_BIAS = 6, 7
_BM, _BN, _BK = 64, 128, 64  # the kernels' output tile and depth chunk
_MAX_SMEM = 232448  # a block's shared memory on the H100


def ln_gemm_smem(K: int) -> int:
    """Shared memory of the LN-prologue GEMM's block over depth K: the
    resident bf16 row panel (64 x (K + 8)), one W tile (128 x 72 bf16) and
    the fp32 C tile (64 x 132)."""
    return _BM * (K + 8) * 2 + _BN * (_BK + 8) * 2 + _BM * (_BN + 4) * 4


# The widest depth (a multiple of 64) whose resident panel fits a block:
# 1344 (DiT-XL's 1152 takes 200,704 bytes; 1408 would take 233,472). The
# half-block kernels take D up to it: D is the LN-prologue product's depth.
LN_GEMM_MAX_K = max(k for k in range(_BK, 4096, _BK) if ln_gemm_smem(k) <= _MAX_SMEM)


def refuse_wide(D: int, kernel: str) -> None:
    """Raise ``NotImplementedError`` naming ROADMAP.md Queue 2 past the
    widest D the half-blocks' LN-prologue GEMM takes (the JAX ladder runs
    kernels there, e.g. D 1536 at N = 64)."""
    if D > LN_GEMM_MAX_K:
        raise NotImplementedError(
            f"{kernel}'s LN-prologue GEMM keeps a 64-row panel of D resident in shared memory, "
            f"D <= {LN_GEMM_MAX_K} on the H100; got D={D}: ROADMAP.md Queue 2 (the half-block "
            "GEMMs past that width)")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ln_gemm(x, scale, bias, w, b, epi: int, with_y: bool = False, fast_gelu: bool = False):
    """``epi(LN(x) w^T + b)`` over (T, K) rows -> ``(out, gelu_grad, y)``:
    ``out`` bf16 (T, Nout); ``gelu_grad`` fp32 (T, Nout) for
    ``EPI_GELU_GRAD``, else None; ``y = bf16(LN(x))`` when ``with_y``. With
    ``fast_gelu`` the GELU epilogues take ``h sigmoid(1.702 h)``."""
    T, K = x.shape
    Nout = w.shape[0]
    out = torch.empty((T, Nout), dtype=torch.bfloat16, device=x.device)
    grad = (torch.empty((T, Nout), dtype=torch.float32, device=x.device)
            if epi == EPI_GELU_GRAD else None)
    y = torch.empty_like(x) if with_y else None
    check_status(load_library().ddm_ln_gemm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _ptr(grad), _ptr(y), T, K, Nout, epi, int(fast_gelu),
        current_stream(x.device)),
        "ln_gemm")
    return out, grad, y


def gemm_residual(a, w, b, res):
    """``bf16(res + (a w^T + b))`` over (T, K) rows."""
    T, K = a.shape
    Nout = w.shape[0]
    out = torch.empty((T, Nout), dtype=torch.bfloat16, device=a.device)
    check_status(load_library().ddm_gemm_residual(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(), out.data_ptr(), T, K, Nout,
        current_stream(a.device)), "gemm_residual")
    return out


def gemm_partial(a, w, epi: int, acc, bias=None, res=None):
    """One hidden chunk of the F-chunked MLP: ``s = a (T, K) . w^T`` with
    ``w (Nout, K)`` a column chunk of nn.Linear's (Nout, F) weight, read in
    place (unit column stride, any row stride). ``PART_STORE`` writes
    ``acc = s`` and ``PART_ADD`` ``acc = acc + s`` into the fp32 (T, Nout)
    ``acc``; ``PART_FINAL_RES`` returns ``bf16((res + (acc + s)) + bias)``."""
    T, K = a.shape
    Nout = w.shape[0]
    if w.stride(1) != 1:
        raise ValueError("gemm_partial reads w with unit column stride")
    out = (torch.empty((T, Nout), dtype=torch.bfloat16, device=a.device)
           if epi == PART_FINAL_RES else None)
    check_status(load_library().ddm_gemm_partial(
        a.data_ptr(), w.data_ptr(), w.stride(0), acc.data_ptr(), _ptr(bias), _ptr(res),
        _ptr(out), T, K, Nout, epi, current_stream(a.device)), "gemm_partial")
    return out


def gemm_nn(a, w, epi: int, dfac=None, bias=None, out=None, fast_gelu: bool = False):
    """``a (T, K) . w (K, Nout)`` with ``w`` in nn.Linear's (out, in) layout,
    or batched over a leading expert axis: ``a (E, T, K) . w (E, K, Nout)``.
    ``w`` may be a strided view (unit column stride), read in place.

    ``NN_F32`` -> fp32 out; ``NN_BF16`` -> bf16 out; ``NN_DGELU`` ->
    ``(bf16(dh), sum_rows(dh))`` with ``dh = (a . w) * dfac`` in fp32;
    ``NN_BIAS`` -> ``bf16(a . w + bias)``; ``NN_BIAS_GELU`` ->
    ``bf16(gelu(h))``, ``h = a . w + bias``; ``NN_BIAS_GELU_GRAD`` ->
    ``(bf16(gelu(h)), gelu'(h) fp32)``. ``bias`` is (Nout,) or (E, Nout).
    The F-chunked expert FFN's partial sums (batched only): ``NN_F32`` into
    a given fp32 ``out``, ``NN_ADD`` adds ``a . w`` into it, and
    ``NN_FINAL_BIAS`` -> ``bf16((dfac + a . w) + bias)`` with ``dfac`` the
    fp32 sum of the earlier chunks. With ``fast_gelu`` the GELU epilogues take
    ``h sigmoid(1.702 h)``.
    """
    batched = a.dim() == 3
    E = a.shape[0] if batched else 1
    T, K = a.shape[-2:]
    Nout = w.shape[-1]
    if w.stride(-1) != 1:
        raise ValueError("gemm_nn reads w with unit column stride")
    dev = a.device
    lead = (E,) if batched else ()
    if out is None:
        out = torch.empty(lead + (T, Nout), device=dev,
                          dtype=torch.float32 if epi in (NN_F32, NN_ADD) else torch.bfloat16)
    aux = dfac
    if epi == NN_BIAS_GELU_GRAD:
        aux = torch.empty(lead + (T, Nout), dtype=torch.float32, device=dev)
    ws = colsum = None
    if epi == NN_DGELU:
        ws = torch.empty((E, -(-T // _BM), Nout), dtype=torch.float32, device=dev)
        colsum = torch.empty(lead + (Nout,), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_gemm_nn(
        a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(aux), out.data_ptr(), _ptr(ws),
        _ptr(colsum), T, K, Nout, w.stride(-2), w.stride(0) if batched else 0, epi, E,
        int(fast_gelu), current_stream(dev)), "gemm_nn")
    if epi == NN_DGELU:
        return out, colsum
    return (out, aux) if epi == NN_BIAS_GELU_GRAD else out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tn_splits(T: int, Ma: int, Nb: int, sms: int, batch: int = 1) -> Tuple[int, int]:
    """``(splits, rows)`` of the split-K weight-gradient product: about four
    blocks per SM, each split a whole number of 64-row chunks. A function of
    the shapes and the card only, so the sum order never changes."""
    tiles = -(-Ma // _BM) * -(-Nb // _BN) * batch
    chunks = -(-T // _BM)
    want = max(1, min(chunks, round(4 * sms / tiles)))
    rows = -(-chunks // want) * _BM
    return -(-T // rows), rows


def gemm_tn(a, b, with_colsum: bool = False, colsum_of_b: bool = False):
    """``a (T, Ma)^T . b (T, Nb)`` in fp32 -> ``(dw (Ma, Nb), colsum)``, or
    batched over a leading expert axis (``a (E, T, Ma)``, ``b (E, T, Nb)``
    -> ``dw (E, Ma, Nb)``): ``colsum`` = fp32 column sums of ``a`` (or of
    ``b`` with ``colsum_of_b``) when ``with_colsum``, else None.
    Deterministic split-K: fixed row ranges, summed in a fixed order."""
    batched = a.dim() == 3
    E = a.shape[0] if batched else 1
    T, Ma = a.shape[-2:]
    Nb = b.shape[-1]
    dev = a.device
    lead = (E,) if batched else ()
    splits, rows = tn_splits(T, Ma, Nb, _sm_count(dev.index or 0), E)
    ws = torch.empty((E, splits, Ma, Nb), dtype=torch.float32, device=dev)
    dw = torch.empty(lead + (Ma, Nb), dtype=torch.float32, device=dev)
    cws = colsum = None
    if with_colsum:
        C = Nb if colsum_of_b else Ma
        cws = torch.empty((E, splits, C), dtype=torch.float32, device=dev)
        colsum = torch.empty(lead + (C,), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_gemm_tn(
        a.data_ptr(), b.data_ptr(), ws.data_ptr(), dw.data_ptr(), _ptr(cws), _ptr(colsum),
        T, Ma, Nb, splits, rows, int(colsum_of_b), E, current_stream(dev)), "gemm_tn")
    return dw, colsum


def ln_bwd(x, dy, dres, scale):
    """LayerNorm backward plus the residual ``dres`` (None: the LN backward
    alone) over (T, D) rows -> ``(dx bf16, dscale fp32, dbias fp32)``."""
    T, D = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    partial = torch.empty((-(-T // _BM), 2, D), dtype=torch.float32, device=dev)
    sums = torch.empty((2, D), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_ln_bwd(
        x.data_ptr(), dy.data_ptr(), _ptr(dres), scale.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), sums.data_ptr(), T, D, current_stream(dev)), "ln_bwd")
    return dx, sums[0], sums[1]


def cast_bf16(src):
    """``bf16(src)`` of an fp32 tensor, in a new contiguous tensor."""
    src = src.contiguous()
    if src.data_ptr() % 16:
        src = src.clone()
    dst = torch.empty(src.shape, dtype=torch.bfloat16, device=src.device)
    check_status(load_library().ddm_cast_bf16(
        src.data_ptr(), dst.data_ptr(), src.numel(), current_stream(src.device)), "cast_bf16")
    return dst
