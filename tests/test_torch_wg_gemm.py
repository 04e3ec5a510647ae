"""The Python side of the wgmma products that K1f and K1b launch
(``ddm_tpu_torch/ops/gemm.py`` ``*_wg``, ``csrc/gemm_wg.cu``; the attention
chains' in ``tests/test_torch_wg_attention.py``), on the CPU:

- the tile plan and the split-K plan are pure functions of the shapes and
  the SM count, each split a whole number of 64-row tiles covering T
  exactly, at T 8 to 524,288 and every (D, F) the MLP tiers give K1;
- the operands there keep the TMA rules (2-D bf16, 16-byte-aligned base
  and row stride), and every block's shared memory fits the card's 227 KB;
- the launchers hand the library the plan's tiles and allocate what the
  kernels write, and K1f's and K1b's chains reach every launch, in order,
  on meta tensors with a stand-in library.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds K1f and K1b through them to the plain versions.
"""

import pytest

torch = pytest.importorskip("torch")

from ddm_tpu_torch.ops import gemm as G  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402

H100_SMS = 132
SM_COUNTS = (H100_SMS, 114, 78)  # H100 SXM, H100 PCIe, and a smaller part
ROWS = (8, 64, 100, 2048, 4096, 16384, 16384 + 37, 131072, 524288)
SMEM = 232448  # a block's shared memory on the H100


def _k1_widths():
    """Every (D, F) at which the MLP tiers launch K1f or K1b, over MLP ratios
    1, 2 and 4 and the row counts above: K1b is the backward of every tier,
    K1f the forward of ``fused`` and ``fwdonly``."""
    widths = {}
    for D in range(128, 4097, 128):
        for ratio in (1, 2, 4):
            for T in ROWS:
                tier = tiers.mlp_tier(T, D, ratio * D)
                if tier is not None:
                    fwd = widths.setdefault((D, ratio * D), False)
                    widths[(D, ratio * D)] = fwd or tier[0] in ("fused", "fwdonly")
    return sorted(widths.items())


K1_WIDTHS = _k1_widths()


def _products(D, F):
    """K1's wgmma products as (kind, output columns, depth): the LN-prologue
    product and the residual product of the forward and the recompute, dh
    and dy, and the two weight gradients as (Ma, Nb)."""
    return {"ln_gemm": (F, D), "residual": (D, F), "nn dh": (F, D), "nn dy": (D, F),
            "tn dW2": (D, F), "tn dW1": (F, D)}


def test_k1_widths_reach_the_wide_tiers():
    widths = dict(K1_WIDTHS)
    assert widths[(384, 1536)] and widths[(768, 3072)]  # DiT-S fused, DiT-B fwdonly
    assert not widths[(1152, 4608)] and not widths[(1536, 6144)]  # fchunked: K1b only
    assert (4096, 4096) in widths and (1408, 1408) in widths


@pytest.mark.parametrize("D,F", [w for w, _ in K1_WIDTHS])
def test_wg_plans_cover_every_k1_shape(D, F):
    """At every row count and SM count, each product's tile plan covers its
    rows and columns exactly once, and each weight gradient's split plan
    cuts T into whole 64-row tiles that cover it exactly; both are the same
    on a second call (functions of the shapes and the SM count only)."""
    for sms in SM_COUNTS:
        for T in ROWS:
            for name, (N, _) in _products(D, F).items():
                if name.startswith("tn"):
                    Ma, Nb = (D, F) if name == "tn dW2" else (F, D)
                    bn, splits, rows = G.wg_split_plan(T, Ma, Nb, sms)
                    assert (bn, splits, rows) == G.wg_split_plan(T, Ma, Nb, sms)
                    assert bn in (128, 192, 256) and bn == G.wg_block_n(Nb)
                    assert rows % G.WG_BK == 0 and 1 <= splits <= 64
                    assert (splits - 1) * rows < T <= splits * rows, (name, T, sms)
                    continue
                most = 8 if name == "ln_gemm" else 4
                bn, tiles, grid = G.wg_tile_plan(T, N, sms, most)
                assert (bn, tiles, grid) == G.wg_tile_plan(T, N, sms, most)
                assert bn in (128, 192, 256) and 1 <= tiles <= most
                ntiles = -(-N // bn)
                assert grid[0] == -(-T // G.WG_BM) and grid[1] == -(-ntiles // tiles)
                assert (grid[1] - 1) * tiles < ntiles <= grid[1] * tiles, (name, T, sms)
                assert ntiles - (grid[1] - 1) * tiles > tiles - grid[1]  # balanced groups


@pytest.mark.parametrize("D,F", [w for w, _ in K1_WIDTHS])
def test_wg_operands_keep_the_tma_rules_and_fit_shared_memory(D, F):
    """Every operand K1 hands a wgmma product at this width is a 2-D bf16
    row-major matrix whose row stride is a multiple of 16 bytes (D, F % 64
    == 0); every block's shared memory, the LN-prologue product's LN tables
    over depth D included, fits 227 KB."""
    T = 4096
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    for t in (meta(T, D), meta(T, F), meta(F, D), meta(D, F)):
        G.tma_operand(t, "operand")
        assert (t.stride(0) * 2) % 16 == 0
    for name, (N, K) in _products(D, F).items():
        kind = name.split()[0]
        if kind == "tn":
            bn = G.wg_split_plan(T, *((D, F) if name == "tn dW2" else (F, D)), H100_SMS)[0]
        else:
            bn = G.wg_tile_plan(T, N, H100_SMS, 8 if kind == "ln_gemm" else 4)[0]
        assert G.wg_smem(kind, bn, K) <= SMEM, (name, bn, K)


def test_wg_ln_gemm_smem_is_its_own_reckoning():
    """The LN-prologue product's shared memory grows with the depth only by
    its fp32 LN tables (the x chunks stream through the ring), unlike the
    resident WMMA panel's, whose bound stays where K6f and K2 use it."""
    assert G.LN_GEMM_MAX_K == 1344 and G.ln_gemm_smem(1152) == 200704
    ring = 1024 + G.WG_STAGES * (128 * 64 * 2 + 192 * 64 * 2) + 128
    assert G.wg_smem("ln_gemm", 192, 384) == ring + 4 * (2 * 128 + 2 * 384)
    assert G.wg_smem("ln_gemm", 256, 4096) - G.wg_smem("ln_gemm", 256, 64) == 4 * 2 * 4032
    assert G.wg_smem("ln_gemm", 256, 4096) <= SMEM < G.ln_gemm_smem(4096)


@pytest.mark.parametrize("T,Ma,Nb,want", [
    (131072, 384, 1536, (192, 10, 13120)),   # DiT-S/4's dW2
    (131072, 1536, 384, (192, 10, 13120)),   # and dW1
    (131072, 1152, 4608, (192, 3, 43712)),   # DiT-XL/4's dW2
    (8, 384, 1536, (192, 1, 64)),
    (100, 64, 256, (256, 2, 64)),
])
def test_wg_split_plan_examples(T, Ma, Nb, want):
    assert G.wg_split_plan(T, Ma, Nb, H100_SMS) == want


@pytest.mark.parametrize("T,N,want", [
    (131072, 1536, (192, 4, (1024, 2))), (16384, 384, (192, 2, (128, 1))),
    (16384, 1536, (192, 4, (128, 2))), (8, 256, (256, 1, (1, 1))),
    (131072, 4096, (256, 4, (1024, 4))), (4096, 1408, (128, 3, (32, 4))),
])
def test_wg_tile_plan_examples(T, N, want):
    assert G.wg_tile_plan(T, N, H100_SMS) == want


@pytest.mark.parametrize("T,N,want", [
    (131072, 1536, (192, 8, (1024, 1))), (16384, 1536, (192, 8, (128, 1))),
    (131072, 4608, (192, 8, (1024, 3))), (4096, 4096, (256, 4, (32, 4))),
])
def test_wg_tile_plan_of_the_ln_prologue_product(T, N, want):
    assert G.wg_tile_plan(T, N, H100_SMS, most=8) == want


@pytest.mark.parametrize("make,what", [
    (lambda: torch.empty((64, 128), dtype=torch.float32, device="meta"), "bf16"),
    (lambda: torch.empty((64, 128), dtype=torch.bfloat16, device="meta").t(), "row-major"),
    (lambda: torch.empty((64, 100), dtype=torch.bfloat16), "16-byte row stride"),
    (lambda: torch.empty((64, 129), dtype=torch.bfloat16)[:, 1:], "16-byte base"),
    (lambda: torch.empty((4, 64, 64), dtype=torch.bfloat16, device="meta"), "2-D"),
])
def test_tma_operand_refuses_what_tma_cannot_load(make, what):
    with pytest.raises(ValueError):
        G.tma_operand(make(), what)


class _FakeLib:
    """Stands in for the kernel library: records each entry point's name
    and arguments and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(G, "load_library", lambda: lib)
    monkeypatch.setattr(G, "current_stream", lambda device: 0)
    monkeypatch.setattr(G, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(TM, "uses_kernel", lambda *t: True)
    return lib


def _meta_mlp(T, D, F):
    x = torch.empty((T, D), dtype=torch.bfloat16, device="meta")
    w = [torch.empty(s, device="meta") for s in ((D,), (D,), (F, D), (F,), (D, F), (D,))]
    return x, w


def test_wg_launchers_pass_the_plans(fake_lib):
    """Each launcher hands the library its plan's tile width and tiles (or
    splits and rows) and allocates what the kernels write."""
    T, D, F = 16384 + 37, 384, 1536
    x = torch.empty((T, D), dtype=torch.bfloat16, device="meta")
    w = torch.empty((F, D), dtype=torch.bfloat16, device="meta")
    f = torch.empty((F,), device="meta")
    s = torch.empty((D,), device="meta")
    out, grad, y = G.ln_gemm_wg(x, s, s, w, f, G.EPI_GELU_GRAD, with_y=True)
    assert (out.dtype, grad.dtype, y.dtype) == (torch.bfloat16, torch.float32, torch.bfloat16)
    assert out.shape == grad.shape == (T, F) and y.shape == (T, D)
    name, args = fake_lib.calls[-1]
    bn, tiles, _ = G.wg_tile_plan(T, F, H100_SMS, most=8)
    assert name == "ddm_wg_ln_gemm" and args[8:15] == (T, D, F, G.EPI_GELU_GRAD, 0, bn, tiles)
    dh, db1 = G.expert_nn_wg(out, w, G.NN_DGELU, dfac=grad)
    assert dh.shape == (T, D) and dh.dtype == torch.bfloat16 and db1.shape == (D,)
    name, args = fake_lib.calls[-1]
    assert name == "ddm_wg_expert_nn" and args[8:] == (
        1, T, F, D, D, 0, G.NN_DGELU, 0, 0, *G.wg_tile_plan(T, D, H100_SMS)[:2], 0)
    dw, cs = G.expert_tn_wg(x, out, with_colsum=True)
    assert dw.shape == (D, F) and dw.dtype == torch.float32 and cs.shape == (D,)
    name, args = fake_lib.calls[-1]
    bn, splits, rows = G.wg_split_plan(T, D, F, H100_SMS)
    assert name == "ddm_wg_expert_tn" and args[6:] == (1, T, D, F, splits, rows, 0, bn, 0)
    with pytest.raises(ValueError):  # NN_BF16 is the attention chains' datt since they moved
        G.expert_nn_wg(out, w, G.NN_BIAS)


@pytest.mark.parametrize("T,D,F", [(131072, 384, 1536), (16384, 768, 3072), (4096, 1408, 1408),
                                   (131072, 1152, 4608), (8, 4096, 4096)])
def test_k1_chains_reach_every_wgmma_launch(fake_lib, T, D, F):
    """K1f is the LN-prologue product then the residual product; K1b's
    chain is the recompute, dW2, dh, dW1, dy and the LayerNorm backward,
    each launch with the plan's tiles; each chain counts one launch."""
    x, w = _meta_mlp(T, D, F)
    before = (TM.LAUNCHES.count, TM.BWD_LAUNCHES.count)
    assert TM._k1f(x, *w).shape == (T, D)
    grads = TM.mlp_block_bwd(x, *w, torch.empty_like(x))
    assert [tuple(g.shape) for g in grads] == [(T, D), (D,), (D,), (F, D), (F,), (D, F), (D,)]
    assert (TM.LAUNCHES.count - before[0], TM.BWD_LAUNCHES.count - before[1]) == (1, 1)
    names = [n for n, _ in fake_lib.calls]
    assert names == ["ddm_wg_ln_gemm", "ddm_wg_gemm_residual", "ddm_wg_ln_gemm",
                     "ddm_wg_expert_tn", "ddm_wg_expert_nn", "ddm_wg_expert_tn", "ddm_wg_expert_nn",
                     "ddm_ln_bwd"]
    ln_f, res, ln_b, tn2, nn_dh, tn1, nn_dy = (a for _, a in fake_lib.calls[:7])
    assert ln_f[8:13] == (T, D, F, G.EPI_GELU, 0) and ln_b[8:12] == (T, D, F, G.EPI_GELU_GRAD)
    assert ln_b[7] is not None and ln_f[7] is not None  # y: the later tiles read it
    assert res[5:8] == (T, F, D) and res[8:10] == G.wg_tile_plan(T, D, H100_SMS)[:2]
    assert tn2[6:10] == (1, T, D, F) and tn2[4] is not None  # dW2 with db2
    assert tn1[6:10] == (1, T, F, D) and tn1[4] is None
    assert nn_dh[8:12] == (1, T, D, F) and nn_dh[14] == G.NN_DGELU
    assert nn_dy[8:12] == (1, T, F, D) and nn_dy[14] == G.NN_F32
