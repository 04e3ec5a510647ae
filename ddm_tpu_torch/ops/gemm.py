"""ctypes launchers for the half-block GEMMs, shared by the MLP, attention
and expert-FFN wrappers: the wgmma products fed by a TMA ring of
``csrc/gemm_wg.cu`` (``*_wg``: K1f, K1b, K6f, K6b, K10b, K10p, and the
chains of K2f, K2b, K4 and the third attention rung at D <= 1344;
``expert_*_wg`` on the expert coordinate), with their tile and split plans,
and the WMMA products of ``csrc/gemm.cu`` and ``csrc/gemm_bwd.cu`` (K10f,
and the earlier designs that ``chip_smoke.py`` times beside the wgmma
chains and X2f's bit check composes).

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
           "cast_bf16", "tn_splits", "sm_count", "ln_gemm_smem", "refuse_wide", "LN_GEMM_MAX_K",
           "ln_gemm_wg", "gemm_residual_wg", "wg_block_n",
           "wg_tile_plan", "wg_split_plan", "wg_smem", "tma_operand", "gemm_partial_wg",
           "expert_nn_wg", "expert_tn_wg"]

# ln_gemm epilogues (csrc/gemm.cu LnGemmEpi)
EPI_BIAS, EPI_GELU, EPI_GELU_GRAD = 0, 1, 2
# gemm_partial epilogues (csrc/gemm.cu PartialEpi; gemm_partial_wg's too)
PART_STORE, PART_ADD, PART_FINAL_RES = 0, 1, 2
# gemm_nn epilogues (csrc/gemm_bwd.cu NNEpi), and expert_nn_wg's (csrc/gemm_wg.cu kNN*Wg)
NN_F32, NN_BF16, NN_DGELU, NN_BIAS, NN_BIAS_GELU, NN_BIAS_GELU_GRAD = 0, 1, 2, 3, 4, 5
NN_ADD, NN_FINAL_BIAS = 6, 7  # expert_nn_wg's alone: the F-chunked expert FFN's sums
_BM, _BN, _BK = 64, 128, 64  # the kernels' output tile and depth chunk
_MAX_SMEM = 232448  # a block's shared memory on the H100


def ln_gemm_smem(K: int) -> int:
    """Shared memory of the resident-panel LN-prologue GEMM's block over
    depth K: the bf16 row panel (64 x (K + 8)), one W tile (128 x 72 bf16)
    and the fp32 C tile (64 x 132)."""
    return _BM * (K + 8) * 2 + _BN * (_BK + 8) * 2 + _BM * (_BN + 4) * 4


# The widest depth (a multiple of 64) whose resident panel fits a block:
# 1344 (DiT-XL's 1152 takes 200,704 bytes; 1408 would take 233,472). It is
# the panel kernel's bound, not ``ln_gemm``'s: past it ``ln_gemm`` runs the
# streamed kernel (``csrc/gemm.cu`` ``ln_gemm_stream_kernel``, ~61 KB at any
# depth), which gives the panel kernel's bits where both take K.
LN_GEMM_MAX_K = max(k for k in range(_BK, 4096, _BK) if ln_gemm_smem(k) <= _MAX_SMEM)


def refuse_wide(D: int, kernel: str) -> None:
    """Raise ``NotImplementedError`` past ``LN_GEMM_MAX_K`` for the attention
    half-block kernels (K2f, K2b, K4), which keep the resident-panel widths:
    the JAX ladder has no attention half-block tier past them (its third
    rung runs there, and so does the port's)."""
    if D > LN_GEMM_MAX_K:
        raise NotImplementedError(
            f"{kernel} runs D <= {LN_GEMM_MAX_K}, the widths of the JAX ladder's attention "
            f"half-block tiers; got D={D}, where the ladder takes the third rung "
            "(fused_attention_block runs it)")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ln_gemm(x, scale, bias, w, b, epi: int, with_y: bool = False, fast_gelu: bool = False,
            streamed: bool = False):
    """``epi(LN(x) w^T + b)`` over (T, K) rows, K % 64 == 0 ->
    ``(out, gelu_grad, y)``: ``out`` bf16 (T, Nout); ``gelu_grad`` fp32 (T,
    Nout) for ``EPI_GELU_GRAD``, else None; ``y = bf16(LN(x))`` when
    ``with_y``. With ``fast_gelu`` the GELU epilogues take ``h sigmoid(1.702
    h)``. K up to ``LN_GEMM_MAX_K`` runs the resident-panel kernel, deeper K
    (or any K with ``streamed``) the streamed one."""
    T, K = x.shape
    Nout = w.shape[0]
    out = torch.empty((T, Nout), dtype=torch.bfloat16, device=x.device)
    grad = (torch.empty((T, Nout), dtype=torch.float32, device=x.device)
            if epi == EPI_GELU_GRAD else None)
    y = torch.empty_like(x) if with_y else None
    lib = load_library()
    launch = lib.ddm_ln_gemm_streamed if streamed else lib.ddm_ln_gemm
    check_status(launch(
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


def gemm_nn(a, w, epi: int, dfac=None, bias=None, fast_gelu: bool = False):
    """``a (T, K) . w (K, Nout)`` with ``w`` in nn.Linear's (out, in) layout,
    or batched over a leading expert axis: ``a (E, T, K) . w (E, K, Nout)``.
    ``w`` may be a strided view (unit column stride), read in place.

    ``NN_F32`` -> fp32 out; ``NN_BF16`` -> bf16 out; ``NN_DGELU`` ->
    ``(bf16(dh), sum_rows(dh))`` with ``dh = (a . w) * dfac`` in fp32;
    ``NN_BIAS`` -> ``bf16(a . w + bias)``; ``NN_BIAS_GELU`` ->
    ``bf16(gelu(h))``, ``h = a . w + bias``; ``NN_BIAS_GELU_GRAD`` ->
    ``(bf16(gelu(h)), gelu'(h) fp32)``. ``bias`` is (Nout,) or (E, Nout).
    With ``fast_gelu`` the GELU epilogues take ``h sigmoid(1.702 h)``.
    """
    batched = a.dim() == 3
    E = a.shape[0] if batched else 1
    T, K = a.shape[-2:]
    Nout = w.shape[-1]
    if w.stride(-1) != 1:
        raise ValueError("gemm_nn reads w with unit column stride")
    dev = a.device
    lead = (E,) if batched else ()
    out = torch.empty(lead + (T, Nout), device=dev,
                      dtype=torch.float32 if epi == NN_F32 else torch.bfloat16)
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
def sm_count(index: int) -> int:
    """The SMs of card ``index`` (the count :func:`tn_splits` plans for)."""
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
    splits, rows = tn_splits(T, Ma, Nb, sm_count(dev.index or 0), E)
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
    alone) over (T, D) rows -> ``(dx bf16, dscale fp32, dbias fp32)``; D up
    to 7264 (8 warps a block up to 3584, 4 past it)."""
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


# --- the wgmma products (csrc/gemm_wg.cu): K1f, K1b and the attention chains ---

WG_BM, WG_BK, WG_STAGES = 128, 64, 4  # output rows a tile, depth a stage, ring stages


def wg_block_n(N: int) -> int:
    """The wgmma tile's width for an output of N columns: 192 where it
    divides N (D 384 is 2 x 192, F 1536 8 x 192), else 256, else 128."""
    return 192 if N % 192 == 0 else 256 if N % 256 == 0 else 128


def wg_smem(kind: str, bn: int, K: int) -> int:
    """Dynamic shared memory of a wgmma block (``csrc/gemm_wg.cu``
    ``wg_smem``): 1024 bytes of alignment slack, the ring's stages (a 128 x
    64 A tile and a bn x 64 B tile, bf16), 128 bytes of barriers, and the
    kind's tables: the LN-prologue product's mean and rstd a row and its
    fp32 LN scale and bias over the depth K; the NN products' (``nn``, and
    ``nt`` with W read K-major) db1 partials of 8 warps; the TN product's two
    halves of column sums; nothing for K6f's ``partial`` product."""
    s = 1024 + WG_STAGES * (WG_BM * WG_BK * 2 + bn * WG_BK * 2) + 128
    extra = {"ln_gemm": 2 * WG_BM + 2 * K, "residual": 0, "partial": 0, "nn": 8 * bn,
             "nt": 8 * bn, "tn": 2 * WG_BM}
    return s + 4 * extra[kind]


def wg_tile_plan(T: int, N: int, sms: int, most: int = 4,
                 batch: int = 1) -> Tuple[int, int, Tuple[int, int]]:
    """``(bn, tiles, grid)`` of a wgmma product with T output rows and N
    columns (of each of ``batch`` experts): a block takes a 128-row tile and
    walks ``tiles`` column tiles of ``bn`` (up to ``most``, fewer where the
    blocks would leave a tenth of the SMs idle; the groups balanced),
    ``grid`` = (row tiles, column groups) an expert. A function of the
    shapes and the SM count. The LN-prologue product walks up to 8: its
    first tile normalises the rows, the others reuse them."""
    bn = wg_block_n(N)
    mblocks, ntiles = -(-T // WG_BM), -(-N // bn)
    tiles = min(ntiles, most)
    while tiles > 1 and batch * mblocks * -(-ntiles // tiles) < 0.9 * sms:
        tiles -= 1
    groups = -(-ntiles // tiles)
    return bn, -(-ntiles // groups), (mblocks, groups)


def wg_split_plan(T: int, Ma: int, Nb: int, sms: int, batch: int = 1) -> Tuple[int, int, int]:
    """``(bn, splits, rows)`` of the split-K weight-gradient product
    ``a (T, Ma)^T . b (T, Nb)`` (of each of ``batch`` experts): each split a
    fixed range of ``rows`` rows, a whole number of 64-row tiles, the splits
    covering T exactly (an expert's T: the splits run within each expert);
    the fewest splits whose blocks (over all experts) fill the card's waves
    to 90%, else the fullest waves of up to 64 splits. A function of the
    shapes and the SM count only, so the sum order never changes."""
    bn = wg_block_n(Nb)
    tiles = batch * -(-Ma // WG_BM) * -(-Nb // bn)
    chunks = -(-T // WG_BK)
    best, best_eff = 1, 0.0
    for want in range(1, min(chunks, 64) + 1):
        blocks = tiles * want
        eff = blocks / (-(-blocks // sms) * sms)
        if blocks >= sms and eff >= 0.9:
            best = want
            break
        if eff > best_eff + 1e-9:
            best, best_eff = want, eff
    rows = -(-chunks // best) * WG_BK
    return bn, -(-T // rows), rows


def tma_operand(t: torch.Tensor, name: str, batched: bool = False) -> None:
    """The TMA rules for a bf16 operand of the wgmma products: a 2-D
    row-major matrix with unit column stride (``batched``: (E, rows, cols),
    the experts' matrices), its base, row stride and expert stride 16-byte
    aligned, at most 2^31 - 1 rows, columns, experts and elements between
    rows or experts; raises otherwise (a view, such as a column chunk of a
    wider weight, passes as it is)."""
    dims = 3 if batched else 2
    if t.dtype != torch.bfloat16 or t.dim() != dims or t.stride(-1) != 1:
        raise ValueError(f"{name}: a TMA operand is a {dims}-D bf16 row-major tensor, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    if (t.data_ptr() % 16 or any((s * 2) % 16 for s in t.stride()[:-1])
            or max(t.shape) >= 2 ** 31 or max(t.stride()) >= 2 ** 31):
        raise ValueError(f"{name}: TMA needs a 16-byte-aligned base and strides, got "
                         f"address {t.data_ptr()} and strides {t.stride()}")


def _sms(dev: torch.device) -> int:
    return sm_count(dev.index or 0)


def ln_gemm_wg(x, scale, bias, w, b, epi: int, with_y: bool = False, fast_gelu: bool = False):
    """:func:`ln_gemm` through the wgmma kernel: ``(out, gelu_grad, y)`` of
    ``epi(LN(x) w^T + b)`` over (T, K) rows, any K % 64 == 0 whose LN tables
    fit (:func:`wg_smem`), ``epi`` and ``fast_gelu`` selecting one of five
    compiled epilogues: ``EPI_BIAS`` (the attention chains' qkv; no
    ``fast_gelu``), or ``EPI_GELU`` and ``EPI_GELU_GRAD``, erf or sigmoid."""
    if epi not in (EPI_BIAS, EPI_GELU, EPI_GELU_GRAD) or (epi == EPI_BIAS and fast_gelu):
        raise ValueError(f"ln_gemm_wg takes EPI_BIAS, EPI_GELU or EPI_GELU_GRAD (fast_gelu "
                         f"with the GELU ones only), got {epi} with fast_gelu={fast_gelu}")
    T, K = x.shape
    N = w.shape[0]
    tma_operand(x, "x")
    tma_operand(w, "w")
    bn, tiles, _ = wg_tile_plan(T, N, _sms(x.device), most=8)
    out = torch.empty((T, N), dtype=torch.bfloat16, device=x.device)
    grad = (torch.empty((T, N), dtype=torch.float32, device=x.device)
            if epi == EPI_GELU_GRAD else None)
    y = torch.empty_like(x)  # written either way: a block's later tiles read it
    check_status(load_library().ddm_wg_ln_gemm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), _ptr(grad), y.data_ptr(), T, K, N, epi, int(fast_gelu), bn, tiles,
        current_stream(x.device)), "ln_gemm_wg")
    return out, grad, y if with_y else None


def gemm_residual_wg(a, w, b, res):
    """:func:`gemm_residual` through the wgmma kernel: ``bf16(res + (a w^T +
    b))`` over (T, K) rows."""
    T, K = a.shape
    N = w.shape[0]
    tma_operand(a, "a")
    tma_operand(w, "w")
    bn, tiles, _ = wg_tile_plan(T, N, _sms(a.device))
    out = torch.empty((T, N), dtype=torch.bfloat16, device=a.device)
    check_status(load_library().ddm_wg_gemm_residual(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr(), out.data_ptr(), T, K, N,
        bn, tiles, current_stream(a.device)), "gemm_residual_wg")
    return out


def gemm_partial_wg(a, w, epi: int, acc, bias=None, res=None):
    """:func:`gemm_partial` through the wgmma kernel (K6f's second product):
    ``s = a (T, K) . w^T`` in fp32, ``w (N, K)`` a column chunk of
    nn.Linear's (N, F) weight read in place (its row stride F, its base the
    chunk's offset). ``PART_STORE`` writes ``acc = s`` and ``PART_ADD`` ``acc
    = acc + s`` into the fp32 (T, N) ``acc``; ``PART_FINAL_RES`` returns
    ``bf16((res + (acc + s)) + bias)``. Each a compiled epilogue."""
    if epi not in (PART_STORE, PART_ADD, PART_FINAL_RES):
        raise ValueError(f"gemm_partial_wg takes PART_STORE, PART_ADD or PART_FINAL_RES, "
                         f"got {epi}")
    T, K = a.shape
    N = w.shape[0]
    tma_operand(a, "a")
    tma_operand(w, "w")
    bn, tiles, _ = wg_tile_plan(T, N, _sms(a.device))
    out = (torch.empty((T, N), dtype=torch.bfloat16, device=a.device)
           if epi == PART_FINAL_RES else None)
    check_status(load_library().ddm_wg_gemm_partial(
        a.data_ptr(), w.data_ptr(), w.stride(0), acc.data_ptr(), _ptr(bias), _ptr(res),
        _ptr(out), T, K, N, epi, bn, tiles, current_stream(a.device)), "gemm_partial_wg")
    return out


def expert_nn_wg(a, w, epi: int, dfac=None, bias=None, fast_gelu: bool = False,
                 transposed: bool = False, acc=None):
    """Per expert e: ``a[e] (T, K) . w[e]`` through the wgmma kernel on the
    expert coordinate, ``a (E, T, K)`` contiguous; ``w[e]`` (K, N) (the
    expert FFN's ``w1 (E, D, F)``, or a hidden chunk of ``w1`` or ``w2``;
    nn.Linear's (out, in) weight read as (K, N)), or with ``transposed`` (N,
    K) and the product ``a[e] . w[e]^T`` (``w2 (E, F, D)`` or ``w1`` read in
    place: no transposed copy); ``w`` may be a view with unit column stride.
    A dense product passes 2-D ``a (T, K)`` and ``w``: the batch of one, its
    outputs 2-D (K1b's and the attention chains' dh, datt and dy).

    ``NN_F32`` -> fp32 (E, T, N); ``NN_BF16`` -> bf16; ``NN_DGELU`` ->
    ``(bf16(dh), sum_rows(dh) (E, N))``, ``dh = (a . w) * dfac`` in fp32.
    Not ``transposed``: ``NN_BIAS_GELU_GRAD`` -> ``(bf16(gelu(h)), gelu'(h)
    fp32)`` and ``NN_BIAS_GELU`` -> ``bf16(gelu(h))``, ``h = a . w +
    bias[e]`` with ``bias (E, N)``, ``fast_gelu`` the sigmoid GELU; and the
    F-chunked expert FFN's fp32 sum ``acc`` (E, T, N), contiguous:
    ``NN_F32`` stores ``a . w`` into it and ``NN_ADD`` adds it (both return
    ``acc``), ``NN_FINAL_BIAS`` -> ``bf16((acc + a . w) + bias[e])``."""
    gelu, sums = (NN_BIAS_GELU, NN_BIAS_GELU_GRAD), (NN_ADD, NN_FINAL_BIAS)
    allowed = (NN_BF16, NN_DGELU) if transposed else (NN_F32, NN_BF16, NN_DGELU, *gelu, *sums)
    if (epi not in allowed or (fast_gelu and epi not in gelu)
            or (bias is None and epi in (*gelu, NN_FINAL_BIAS))
            or (acc is None and epi in sums) or (acc is not None and epi not in (NN_F32, *sums))):
        raise ValueError(f"expert_nn_wg takes {allowed} (transposed={transposed}; fast_gelu "
                         f"with the GELU codes only; a bias with the GELU codes and "
                         f"NN_FINAL_BIAS; acc with NN_ADD and NN_FINAL_BIAS, or NN_F32), got "
                         f"{epi} with fast_gelu={fast_gelu}, bias {bias is not None}, acc "
                         f"{acc is not None}")
    dense = a.dim() == 2
    tma_operand(a, "a", batched=not dense)
    tma_operand(w, "w", batched=not dense)
    if not a.is_contiguous():
        raise ValueError("expert_nn_wg reads a as contiguous (E, T, K) slot rows")
    E, T, K = (1, *a.shape) if dense else a.shape
    N = w.shape[-2] if transposed else w.shape[-1]
    ldw, sw = (w.stride(0), 0) if dense else (w.stride(1), w.stride(0))
    lead = () if dense else (E,)
    dev = a.device
    if acc is not None and (acc.dtype != torch.float32 or tuple(acc.shape) != (*lead, T, N)
                            or not acc.is_contiguous()):
        raise ValueError(f"expert_nn_wg: acc must be a contiguous fp32 {(*lead, T, N)}, got "
                         f"{acc.dtype} {tuple(acc.shape)}")
    bn, tiles, grid = wg_tile_plan(T, N, _sms(dev), batch=E)
    if acc is not None and epi != NN_FINAL_BIAS:
        out = acc
    else:
        out = torch.empty((*lead, T, N), device=dev,
                          dtype=torch.float32 if epi == NN_F32 else torch.bfloat16)
    out2 = (torch.empty((*lead, T, N), dtype=torch.float32, device=dev)
            if epi == NN_BIAS_GELU_GRAD else None)
    ws = colsum = None
    if epi == NN_DGELU:
        ws = torch.empty((E, grid[0], N), dtype=torch.float32, device=dev)
        colsum = torch.empty((*lead, N), dtype=torch.float32, device=dev)
    # the add and final epilogues read the earlier chunks' sum where dh reads gelu'
    part = acc if epi in sums else dfac
    check_status(load_library().ddm_wg_expert_nn(
        a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(part), out.data_ptr(), _ptr(out2),
        _ptr(ws), _ptr(colsum), E, T, K, N, ldw, sw, epi, int(fast_gelu), int(transposed), bn,
        tiles, current_stream(dev)), "expert_nn_wg")
    if epi == NN_DGELU:
        return out, colsum
    return (out, out2) if epi == NN_BIAS_GELU_GRAD else out


def expert_tn_wg(a, b, with_colsum: bool = False, colsum_of_b: bool = False):
    """Per expert e: ``a[e] (T, Ma)^T . b[e] (T, Nb)`` in fp32 through the
    wgmma kernel on the expert coordinate, ``a (E, T, Ma)`` and ``b (E, T,
    Nb)`` contiguous -> ``(dw (E, Ma, Nb), colsum)``: ``colsum`` the fp32
    column sums of ``a`` (E, Ma), or with ``colsum_of_b`` of ``b`` (E, Nb),
    when ``with_colsum``, else None. A dense product passes 2-D ``a (T, Ma)``
    and ``b (T, Nb)``: the batch of one, ``dw (Ma, Nb)`` and ``colsum`` 1-D
    (K1b's and the attention chains' weight gradients). Deterministic
    split-K (:func:`wg_split_plan` over the batch): fixed row ranges within
    each expert, summed in a fixed order (one split writes ``dw``
    directly)."""
    dense = a.dim() == 2
    tma_operand(a, "a", batched=not dense)
    tma_operand(b, "b", batched=not dense)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("expert_tn_wg reads a and b as contiguous (E, T, *) rows")
    E, T, Ma = (1, *a.shape) if dense else a.shape
    Nb = b.shape[-1]
    lead = () if dense else (E,)
    dev = a.device
    bn, splits, rows = wg_split_plan(T, Ma, Nb, _sms(dev), batch=E)
    ws = (torch.empty((E, splits, Ma, Nb), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    dw = torch.empty((*lead, Ma, Nb), dtype=torch.float32, device=dev)
    cws = colsum = None
    if with_colsum:
        C = Nb if colsum_of_b else Ma
        cws = torch.empty((E, splits, C), dtype=torch.float32, device=dev)
        colsum = torch.empty((*lead, C), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_wg_expert_tn(
        a.data_ptr(), b.data_ptr(), _ptr(ws), dw.data_ptr(), _ptr(cws), _ptr(colsum), E,
        T, Ma, Nb, splits, rows, int(colsum_of_b), bn, current_stream(dev)), "expert_tn_wg")
    return dw, colsum
