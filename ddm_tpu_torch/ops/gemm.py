"""ctypes launchers for the half-block GEMMs, shared by the MLP, attention
and expert-FFN wrappers: the wgmma products fed by a TMA ring of
``csrc/gemm_wg.cu`` (``*_wg``: K1f, K1b, and the chains of K2f, K2b, K4
and the third attention rung at D <= 1344), with their tile and split
plans, and the WMMA products of ``csrc/gemm.cu`` and ``csrc/gemm_bwd.cu``
(K6, K10, and the WMMA K2f chain X2f's bit check composes).

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
           "ln_gemm_wg", "gemm_residual_wg", "gemm_nn_wg", "gemm_tn_wg", "wg_block_n",
           "wg_tile_plan", "wg_split_plan", "wg_smem", "tma_operand"]

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
    fp32 LN scale and bias over the depth K; the NN product's db1 partials
    of 8 warps; the TN product's two halves of column sums."""
    s = 1024 + WG_STAGES * (WG_BM * WG_BK * 2 + bn * WG_BK * 2) + 128
    extra = {"ln_gemm": 2 * WG_BM + 2 * K, "residual": 0, "nn": 8 * bn, "tn": 2 * WG_BM}
    return s + 4 * extra[kind]


def wg_tile_plan(T: int, N: int, sms: int, most: int = 4) -> Tuple[int, int, Tuple[int, int]]:
    """``(bn, tiles, grid)`` of a wgmma product with T output rows and N
    columns: a block takes a 128-row tile and walks ``tiles`` column tiles
    of ``bn`` (up to ``most``, fewer where the blocks would leave a tenth
    of the SMs idle; the groups balanced), ``grid`` = (row tiles, column
    groups). A function of the shapes and the SM count. The LN-prologue
    product walks up to 8: its first tile normalises the rows, the others
    reuse them."""
    bn = wg_block_n(N)
    mblocks, ntiles = -(-T // WG_BM), -(-N // bn)
    tiles = min(ntiles, most)
    while tiles > 1 and mblocks * -(-ntiles // tiles) < 0.9 * sms:
        tiles -= 1
    groups = -(-ntiles // tiles)
    return bn, -(-ntiles // groups), (mblocks, groups)


def wg_split_plan(T: int, Ma: int, Nb: int, sms: int) -> Tuple[int, int, int]:
    """``(bn, splits, rows)`` of the split-K weight-gradient product
    ``a (T, Ma)^T . b (T, Nb)``: each split a fixed range of ``rows`` rows,
    a whole number of 64-row tiles, the splits covering T exactly; the
    fewest splits whose blocks fill the card's waves to 90%, else the
    fullest waves of up to 64 splits. A function of the shapes and the SM
    count only, so the sum order never changes."""
    bn = wg_block_n(Nb)
    tiles = -(-Ma // WG_BM) * -(-Nb // bn)
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


def tma_operand(t: torch.Tensor, name: str) -> None:
    """The TMA rules for a bf16 operand of the wgmma products: 2-D,
    row-major with unit column stride, its base and row stride 16-byte
    aligned, at most 2^31 - 1 rows and columns; raises otherwise."""
    if t.dtype != torch.bfloat16 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: a TMA operand is a 2-D bf16 row-major matrix, got "
                         f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % 16 or (t.stride(0) * 2) % 16 or max(t.shape) >= 2 ** 31:
        raise ValueError(f"{name}: TMA needs a 16-byte-aligned base and row stride, got "
                         f"address {t.data_ptr()} and row stride {t.stride(0)}")


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


def gemm_nn_wg(a, w, epi: int, dfac=None):
    """``a (T, K) . w (K, N)`` with ``w`` nn.Linear's (out, in) weight read as
    (K, N), through the wgmma kernel: ``NN_F32`` -> fp32 out; ``NN_BF16`` ->
    bf16 out (the attention chains' datt); ``NN_DGELU`` -> ``(bf16(dh),
    sum_rows(dh))``, ``dh = (a . w) * dfac`` in fp32."""
    if epi not in (NN_F32, NN_BF16, NN_DGELU):
        raise ValueError(f"gemm_nn_wg takes NN_F32, NN_BF16 or NN_DGELU, got {epi}")
    T, K = a.shape
    N = w.shape[1]
    tma_operand(a, "a")
    tma_operand(w, "w")
    dev = a.device
    bn, tiles, grid = wg_tile_plan(T, N, _sms(dev))
    out = torch.empty((T, N), device=dev,
                      dtype=torch.float32 if epi == NN_F32 else torch.bfloat16)
    ws = colsum = None
    if epi == NN_DGELU:
        ws = torch.empty((grid[0], N), dtype=torch.float32, device=dev)
        colsum = torch.empty((N,), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_wg_gemm_nn(
        a.data_ptr(), w.data_ptr(), _ptr(dfac), out.data_ptr(), _ptr(ws), _ptr(colsum), T, K,
        N, epi, bn, tiles, current_stream(dev)), "gemm_nn_wg")
    return (out, colsum) if epi == NN_DGELU else out


def gemm_tn_wg(a, b, with_colsum: bool = False):
    """``a (T, Ma)^T . b (T, Nb)`` in fp32 through the wgmma kernel ->
    ``(dw (Ma, Nb), colsum)``: ``colsum`` the fp32 column sums of ``a``
    when ``with_colsum``, else None. Deterministic split-K
    (:func:`wg_split_plan`): fixed row ranges, summed in a fixed order."""
    T, Ma = a.shape
    Nb = b.shape[1]
    tma_operand(a, "a")
    tma_operand(b, "b")
    dev = a.device
    bn, splits, rows = wg_split_plan(T, Ma, Nb, _sms(dev))
    ws = torch.empty((splits, Ma, Nb), dtype=torch.float32, device=dev)
    dw = torch.empty((Ma, Nb), dtype=torch.float32, device=dev)
    cws = colsum = None
    if with_colsum:
        cws = torch.empty((splits, Ma), dtype=torch.float32, device=dev)
        colsum = torch.empty((Ma,), dtype=torch.float32, device=dev)
    check_status(load_library().ddm_wg_gemm_tn(
        a.data_ptr(), b.data_ptr(), ws.data_ptr(), dw.data_ptr(), _ptr(cws), _ptr(colsum), T,
        Ma, Nb, splits, rows, bn, current_stream(dev)), "gemm_tn_wg")
    return dw, colsum
