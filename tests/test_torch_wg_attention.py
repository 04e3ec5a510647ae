"""The attention half-block's chains on the wgmma products
(``ddm_tpu_torch/ops/attention.py`` ``_fwd_chain`` / ``_bwd_chain`` on
``ops/gemm.py`` ``*_wg``, ``csrc/gemm_wg.cu``), on the CPU:

- at every width the chains take (D a multiple of 64 up to 1344) and at T
  48 (ragged against the 128-row tile), 16,384 and 131,072, each of the six
  products' tile or split plan covers its output exactly, its operands keep
  the TMA rules and its block's shared memory fits the card's 227 KB;
- K2f, K2b, K4 and the third rung (around K7, K8 and the plain core) reach
  every wgmma launch of their chains, in order, with the epilogue codes and
  plans the chains hand them, and no WMMA product, on meta tensors with a
  stand-in library; each chain counts one launch.

The kernels run only on the card: ``tests/test_torch_cuda.py`` holds the
chains to the plain versions there.
"""

import pytest

torch = pytest.importorskip("torch")

from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import flash as TF  # noqa: E402
from ddm_tpu_torch.ops import gemm as G  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402

H100_SMS = 132
SM_COUNTS = (H100_SMS, 114, 78)  # H100 SXM, H100 PCIe, and a smaller part
ROWS = (48, 16384, 131072)  # B 3 x N 16; the sampler's and the trainer's DiT-S/4 rows
SMEM = 232448  # a block's shared memory on the H100
WIDTHS = tuple(range(64, G.LN_GEMM_MAX_K + 1, 64))
WG_LAUNCHES = ("ddm_wg_ln_gemm", "ddm_wg_gemm_residual", "ddm_wg_gemm_nn", "ddm_wg_gemm_tn")
WMMA_LAUNCHES = ("ddm_ln_gemm", "ddm_ln_gemm_streamed", "ddm_gemm_residual", "ddm_gemm_nn",
                 "ddm_gemm_tn", "ddm_gemm_partial")


def _products(D):
    """K2's wgmma products at width D as ``(kind, N, K)`` (output columns and
    depth), the weight gradients as ``(kind, Ma, Nb)``."""
    return {"qkv": ("ln_gemm", 3 * D, D), "proj": ("residual", D, D), "datt": ("nn", D, D),
            "dy": ("nn", D, 3 * D), "dWproj": ("tn", D, D), "dWqkv": ("tn", 3 * D, D)}


def test_widths_are_every_chain_width():
    assert WIDTHS[0] == 64 and WIDTHS[-1] == 1344 and len(WIDTHS) == 21
    assert G.wg_block_n(3 * 64) == G.wg_block_n(3 * 1344) == 192  # 3D % 192 == 0 always
    assert [G.wg_block_n(D) for D in (64, 320, 384, 448, 1024, 1152)] == [
        128, 128, 192, 128, 256, 192]


@pytest.mark.parametrize("D", WIDTHS)
def test_wg_plans_cover_every_k2_product(D):
    """At every row count and SM count, each K2 product's tile plan covers
    its rows and columns exactly once (ragged column tiles at D 64, 320,
    448 ...), and each weight gradient's split plan cuts T into whole 64-row
    tiles that cover it exactly; both are the same on a second call."""
    for sms in SM_COUNTS:
        for T in ROWS:
            for name, (kind, N, K) in _products(D).items():
                if kind == "tn":
                    bn, splits, rows = G.wg_split_plan(T, N, K, sms)
                    assert (bn, splits, rows) == G.wg_split_plan(T, N, K, sms)
                    assert bn == G.wg_block_n(K) and rows % G.WG_BK == 0
                    assert 1 <= splits <= 64 and (splits - 1) * rows < T <= splits * rows, (
                        name, T, sms)
                    continue
                most = 8 if kind == "ln_gemm" else 4
                bn, tiles, grid = G.wg_tile_plan(T, N, sms, most)
                assert (bn, tiles, grid) == G.wg_tile_plan(T, N, sms, most)
                assert bn == G.wg_block_n(N) and 1 <= tiles <= most
                ntiles = -(-N // bn)
                assert grid[0] == -(-T // G.WG_BM) and grid[1] == -(-ntiles // tiles)
                assert (grid[1] - 1) * tiles < ntiles <= grid[1] * tiles, (name, T, sms)
                assert (ntiles - 1) * bn < N <= ntiles * bn


@pytest.mark.parametrize("D", WIDTHS)
def test_k2_operands_keep_the_tma_rules_and_fit_shared_memory(D):
    """Every operand the chains hand a wgmma product at width D keeps the TMA
    rules: x, y, qkv, att, datt, dout and dqkv as the chains view them
    ((B*N, D) and (B*N, 3D) rows of whole buffers) and both weights; every
    block's shared memory, the LN product's tables over depth D included,
    fits 227 KB (at D 1344 the qkv product takes 176,768 bytes)."""
    B, N = 3, 16
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    views = {"x": meta(B, N, D).reshape(B * N, D), "qkv": meta(B, N, 3 * D).view(B * N, 3 * D),
             "att": meta(B, N, D).view(B * N, D), "dqkv": meta(B, N, 3 * D).view(B * N, 3 * D),
             "dob": meta(B, N, D).contiguous().reshape(B * N, D), "y": meta(B * N, D),
             "wqkv": meta(3 * D, D), "wproj": meta(D, D)}
    for name, t in views.items():
        G.tma_operand(t, name)
    for T in ROWS:
        for name, (kind, N_, K) in _products(D).items():
            if kind == "tn":
                bn, depth = G.wg_split_plan(T, N_, K, H100_SMS)[0], T
            else:
                bn, depth = G.wg_tile_plan(T, N_, H100_SMS, 8 if kind == "ln_gemm" else 4)[0], K
            assert G.wg_smem(kind, bn, depth) <= SMEM, (name, bn, depth)
    assert G.wg_smem("ln_gemm", 192, 1344) == 176768


class _FakeLib:
    """Stands in for the kernel library: records each entry point's name and
    arguments, and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call

    def names(self, start=0):
        return [n for n, _ in self.calls[start:] if n != "ddm_attention_core_plan"]

    def products(self, start=0):
        return [(n, a) for n, a in self.calls[start:] if n in WG_LAUNCHES + WMMA_LAUNCHES]


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    for module in (G, TA, TF):
        monkeypatch.setattr(module, "load_library", lambda: lib)
        monkeypatch.setattr(module, "current_stream", lambda device: 0)
    monkeypatch.setattr(G, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(TA, "uses_kernel", lambda *t: True)
    return lib


def _meta_block(B, N, D, grad=False):
    x = torch.empty((B, N, D), dtype=torch.bfloat16, device="meta", requires_grad=grad)
    w = [torch.empty(s, device="meta", requires_grad=grad)
         for s in ((D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,))]
    return x, w


def _assert_forward_products(calls, T, D):
    """The forward chain's two products: the qkv product with the bias
    epilogue, then the projection with the residual, each with its plan."""
    (ln, ln_args), (res, res_args) = calls
    assert ln == "ddm_wg_ln_gemm" and ln_args[8:13] == (T, D, 3 * D, G.EPI_BIAS, 0)
    assert ln_args[13:15] == G.wg_tile_plan(T, 3 * D, H100_SMS, most=8)[:2]
    assert res == "ddm_wg_gemm_residual" and res_args[5:8] == (T, D, D)
    assert res_args[8:10] == G.wg_tile_plan(T, D, H100_SMS)[:2]


def _assert_backward_products(calls, T, D):
    """The backward chain's five products, in order: the qkv recompute (y
    written and returned), datt (bf16), dWproj + dbproj, dWqkv + dbqkv, dy
    (fp32), each with its plan."""
    assert [n for n, _ in calls] == ["ddm_wg_ln_gemm", "ddm_wg_gemm_nn", "ddm_wg_gemm_tn",
                                     "ddm_wg_gemm_tn", "ddm_wg_gemm_nn"]
    ln, datt, dwproj, dwqkv, dy = (a for _, a in calls)
    assert ln[8:13] == (T, D, 3 * D, G.EPI_BIAS, 0) and ln[7] is not None
    assert datt[6:10] == (T, D, D, G.NN_BF16) and datt[10:12] == G.wg_tile_plan(
        T, D, H100_SMS)[:2] and datt[2] is None and datt[4] is None
    for args, Ma in ((dwproj, D), (dwqkv, 3 * D)):
        bn, splits, rows = G.wg_split_plan(T, Ma, D, H100_SMS)
        assert args[6:] == (T, Ma, D, splits, rows, bn, 0) and args[4] is not None
    assert dy[6:10] == (T, 3 * D, D, G.NN_F32)


# (B, N, D, H): DiT-S/4 sampling and training (D 384, H 6), DiT-B and DiT-L
# (K4), DiT-XL (K4, Dh 72), ragged T (B 3, N 16) at D 128 and 256 through
# the entry points; and, with no tier there, K2's chains called directly at
# ragged column tiles (D 64, 320) and the widest chain (D 1344)
K2_SHAPES = [(256, 64, 384, 6), (2048, 64, 384, 6), (64, 64, 768, 12), (2048, 64, 1024, 16),
             (2048, 64, 1152, 16), (3, 16, 128, 2), (3, 16, 256, 4), (3, 16, 64, 1),
             (3, 16, 320, 5), (5, 64, 1344, 21)]


@pytest.mark.parametrize("B,N,D,H", K2_SHAPES)
def test_k2_chains_reach_every_wgmma_launch(fake_lib, B, N, D, H):
    """K2f is the qkv product, the core and the projection product; K2b (or
    K4, where the ladder's tier is split) is the recompute, datt, the core
    backward, dWproj, dWqkv, dy and the LayerNorm backward; every product on
    the wgmma ring with its plan, none on WMMA; each chain counts one
    launch on its own counter."""
    T = B * N
    tier = tiers.attention_tier(B, N, D, H)
    x, w = _meta_block(B, N, D)
    dout = torch.empty_like(x)
    if tier is None:  # the chains themselves, as the card tests call them
        fwd, bwd = (lambda: TA._k2f(x, *w, H)), (lambda: TA._k2b(x, *w, H, dout))
    else:
        fwd = lambda: TA.fused_attention_block(x, *w, H)  # noqa: E731
        bwd = lambda: TA.attention_block_bwd(x, *w, H, dout)  # noqa: E731
    counters = (TA.LAUNCHES, TA.BWD_LAUNCHES, TA.SPLIT_BWD_LAUNCHES)
    before = [c.count for c in counters]
    assert fwd().shape == (B, N, D)
    assert fake_lib.names() == ["ddm_wg_ln_gemm", "ddm_attention_core", "ddm_wg_gemm_residual"]
    _assert_forward_products(fake_lib.products(), T, D)
    start = len(fake_lib.calls)
    grads = bwd()
    assert [tuple(g.shape) for g in grads] == [(B, N, D), (D,), (D,), (3 * D, D), (3 * D,),
                                               (D, D), (D,)]
    assert fake_lib.names(start) == ["ddm_wg_ln_gemm", "ddm_wg_gemm_nn", "ddm_attention_core_bwd",
                                     "ddm_wg_gemm_tn", "ddm_wg_gemm_tn", "ddm_wg_gemm_nn",
                                     "ddm_ln_bwd"]
    _assert_backward_products(fake_lib.products(start), T, D)
    split = tier == "split"
    assert [c.count - n for c, n in zip(counters, before)] == [1, int(not split), int(split)]


# (B, N, D, H, core): the third rung around K7 (DiT-L and DiT-XL at 64 px),
# K8 (128 px at Dh 64 and 128) and the plain core (96 px; ragged T and
# column tiles at D 320; D 1344 over 21 heads), at D <= 1344
RUNG3_SHAPES = [(8, 256, 1024, 16, "K7"), (8, 256, 1152, 16, "K7"), (2, 1024, 384, 6, "K8"),
                (2, 1024, 384, 3, "K8"), (2, 576, 384, 6, None), (3, 16, 320, 5, None),
                (5, 64, 1344, 21, None)]


@pytest.mark.parametrize("B,N,D,H,core", RUNG3_SHAPES)
def test_rung3_chains_reach_every_wgmma_launch(fake_lib, B, N, D, H, core):
    """The third rung at D <= 1344 runs K2's chains around its core, through
    autograd: the forward's two wgmma products around K7f, K8f or the plain
    core, and the backward's five around K7b, K8b or the plain core's
    backward, none on WMMA."""
    assert tiers.attention_tier(B, N, D, H) is None and tiers.core_tier(B, N, D, H) == core
    T = B * N
    x, w = _meta_block(B, N, D, grad=True)
    out = TA.fused_attention_block(x, *w, H)
    assert out.shape == (B, N, D)
    cores = {"K7": ["ddm_attention_core"], "K8": ["ddm_flash_fwd"], None: []}
    assert fake_lib.names() == ["ddm_wg_ln_gemm", *cores[core], "ddm_wg_gemm_residual"]
    _assert_forward_products(fake_lib.products(), T, D)
    start = len(fake_lib.calls)
    out.backward(torch.empty_like(out))
    assert x.grad.shape == (B, N, D) and w[2].grad.shape == (3 * D, D)
    core_bwd = {"K7": ["ddm_attention_core_bwd"], "K8": ["ddm_flash_bwd"], None: []}
    assert fake_lib.names(start) == ["ddm_wg_ln_gemm", "ddm_wg_gemm_nn", *core_bwd[core],
                                     "ddm_wg_gemm_tn", "ddm_wg_gemm_tn", "ddm_wg_gemm_nn",
                                     "ddm_ln_bwd"]
    _assert_backward_products(fake_lib.products(start), T, D)


def test_launchers_take_the_attention_codes_and_refuse_the_rest(fake_lib):
    """``ln_gemm_wg`` takes ``EPI_BIAS`` (without ``fast_gelu``) and
    ``gemm_nn_wg`` takes ``NN_BF16``, allocating bf16 outputs; every other
    code raises before a launch."""
    T, D = 48, 320
    x = torch.empty((T, D), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3 * D, D), dtype=torch.bfloat16, device="meta")
    s = torch.empty((D,), device="meta")
    out, grad, y = G.ln_gemm_wg(x, s, s, w, torch.empty((3 * D,), device="meta"), G.EPI_BIAS,
                                with_y=True)
    assert out.dtype == torch.bfloat16 and out.shape == (T, 3 * D) and grad is None
    assert y.shape == (T, D)
    datt = G.gemm_nn_wg(x, torch.empty((D, D), dtype=torch.bfloat16, device="meta"), G.NN_BF16)
    assert datt.dtype == torch.bfloat16 and datt.shape == (T, D)
    calls = len(fake_lib.calls)
    with pytest.raises(ValueError):
        G.ln_gemm_wg(x, s, s, w, s, G.EPI_BIAS, fast_gelu=True)
    for epi in (3, -1):
        with pytest.raises(ValueError):
            G.ln_gemm_wg(x, s, s, w, s, epi)
    for epi in (G.NN_BIAS, G.NN_BIAS_GELU, G.NN_ADD, G.NN_FINAL_BIAS):
        with pytest.raises(ValueError):
            G.gemm_nn_wg(x, w, epi)
    assert len(fake_lib.calls) == calls
