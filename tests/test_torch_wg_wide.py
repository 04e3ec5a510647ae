"""The F-chunked MLP forward K6f and the expert FFN backward K10b on the
wgmma products (``ddm_tpu_torch/ops/mlp_block.py`` ``_k6f``,
``ops/expert_ffn.py`` ``_k10b``; ``ops/gemm.py`` ``*_wg``,
``csrc/gemm_wg.cu``), on the CPU, on meta tensors with a stand-in library:

- K6f at every (T, D, F, k) the ladder tiers ``fchunked`` (D 1024-4096, k
  2-8, T ragged against the 128-row tile too) and the tensor-parallel
  partial: each hidden chunk reaches the LN-prologue product on the W1 row
  chunk, then the partial product on the W2 column chunk read in place
  (leading dimension F, the chunk's offset), with the store, add and final
  codes in chunk order; the tile plans cover each output exactly and every
  block's shared memory fits 227 KB; no WMMA launch;
- K10b at E 2-512, S ragged against 128, DiT-S, DiT-B and DiT-XL widths:
  five expert-coordinate launches in order with E passed, the weights and
  slot rows read in place (no transposed copy), split plans that cover each
  expert's rows exactly; no WMMA launch.

The kernels run only on the card: ``tests/test_torch_cuda.py`` holds them
to the plain versions there.
"""

import pytest

torch = pytest.importorskip("torch")

from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402
from ddm_tpu_torch.ops import gemm as G  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402

H100_SMS = 132
SMEM = 232448  # a block's shared memory on the H100
BF = torch.bfloat16
WMMA_LAUNCHES = ("ddm_ln_gemm", "ddm_ln_gemm_streamed", "ddm_gemm_residual", "ddm_gemm_nn",
                 "ddm_gemm_tn", "ddm_gemm_partial")
ROWS = (1000, 16384, 131072)  # ragged, the sampler's and the trainer's rows


def _fchunked_shapes():
    """``{(D, F): [(T, k), ...]}`` over D 1024-4096 (multiples of 128) at MLP
    ratios 1-4 and 8/3, for each row count the ladder tiers ``fchunked``."""
    out = {}
    for D in range(1024, 4097, 128):
        for F in sorted({D, 2 * D, 3 * D, 4 * D, D * 8 // 3 // 128 * 128}):
            for T in ROWS:
                tier = tiers.mlp_tier(T, D, F)
                if tier is not None and tier[0] == "fchunked":
                    out.setdefault((D, F), []).append((T, tier[1]))
    return out


FCHUNKED = _fchunked_shapes()


def test_fchunked_shapes_span_the_ladders_wide_tier():
    """The cases reach from DiT-L (D 1024, k 2) to D 4096 (k 8), with
    DiT-XL/4 (k 2), SD3-Medium's width (D 1536, F 6144, k 8) and every k."""
    ks = {k for cases in FCHUNKED.values() for _, k in cases}
    assert ks == {2, 4, 8}
    assert (1000, 2) in FCHUNKED[(1024, 4096)] and (131072, 2) in FCHUNKED[(1152, 4608)]
    assert (131072, 8) in FCHUNKED[(1536, 6144)] and (131072, 8) in FCHUNKED[(4096, 4096)]
    assert min(D for D, _ in FCHUNKED) == 1024 and max(D for D, _ in FCHUNKED) == 4096


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

    def names(self):
        return [n for n, _ in self.calls]


@pytest.fixture()
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(G, "load_library", lambda: lib)
    monkeypatch.setattr(G, "current_stream", lambda device: 0)
    monkeypatch.setattr(G, "_sms", lambda device: H100_SMS)
    for module in (TM, TX):
        monkeypatch.setattr(module, "uses_kernel", lambda *t: True)
    return lib


def _arena(*shapes, dtype=BF):
    """Meta tensors of ``shapes`` laid one after another in one meta buffer:
    each has its own address (a meta tensor's data_ptr is its byte offset),
    so a launch's pointers tell which tensor, and where in it, it reads."""
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    buf = torch.empty(sum(sizes) + 64 * len(sizes), dtype=dtype, device="meta")
    out, off = [], 64
    for s, n in zip(shapes, sizes):
        out.append(buf[off:off + n].view(s))
        off += n + 64
    return out


def _covers(T, N, plan, most):
    """A wgmma tile plan covers its T rows and N columns exactly once."""
    bn, tiles, grid = plan
    ntiles = -(-N // bn)
    assert bn == G.wg_block_n(N) and 1 <= tiles <= most
    assert grid[0] == -(-T // G.WG_BM) and (grid[1] - 1) * tiles < ntiles <= grid[1] * tiles
    assert (ntiles - 1) * bn < N <= ntiles * bn


def _assert_k6f_chunks(calls, x, w1, w2, T, D, F, k, final=True):
    """Each chunk c: ``ddm_wg_ln_gemm`` on W1's row chunk c, then
    ``ddm_wg_gemm_partial`` on W2's column chunk c read in place, with the
    store (first), add (middle) and final (last) codes and their plans."""
    fc = F // k
    assert [n for n, _ in calls] == ["ddm_wg_ln_gemm", "ddm_wg_gemm_partial"] * k
    acc = None
    for c in range(k):
        (_, ln), (_, part) = calls[2 * c:2 * c + 2]
        plan = G.wg_tile_plan(T, fc, H100_SMS, most=8)
        assert ln[0] == x.data_ptr() and ln[3] == w1.data_ptr() + c * fc * D * 2
        assert ln[8:15] == (T, D, fc, G.EPI_GELU, 0, *plan[:2])
        _covers(T, fc, plan, 8)
        assert G.wg_smem("ln_gemm", plan[0], D) <= SMEM
        epi = (G.PART_STORE if c == 0 else
               G.PART_FINAL_RES if final and c == k - 1 else G.PART_ADD)
        plan = G.wg_tile_plan(T, D, H100_SMS)
        assert part[0] == ln[5]  # the chunk's hidden activation
        assert part[1] == w2.data_ptr() + c * fc * 2 and part[2] == F  # in place, ld F
        assert part[7:13] == (T, fc, D, epi, *plan[:2])
        _covers(T, D, plan, 4)
        assert G.wg_smem("partial", plan[0], fc) <= SMEM
        acc = part[3] if acc is None else acc
        assert part[3] == acc  # one fp32 sum for every chunk
        assert (part[6] is None) == (epi != G.PART_FINAL_RES)  # the bf16 output, last
        if epi == G.PART_FINAL_RES:
            assert part[4] is not None and part[5] == x.data_ptr()  # b2, the residual


@pytest.mark.parametrize("D,F", sorted(FCHUNKED))
def test_k6f_chunks_reach_the_wgmma_products_in_order(fake_lib, D, F):
    """Through ``fused_mlp_block`` at every row count the ladder tiers
    ``fchunked``: k chunks, two wgmma launches each, one K6f counted a
    chunk, no WMMA product."""
    for T, k in FCHUNKED[(D, F)]:
        start = len(fake_lib.calls)
        x, w1, w2 = _arena((T, D), (F, D), (D, F))
        vecs = [torch.empty(n, device="meta") for n in (D, D, F, D)]
        before = (TM.PARTIAL_LAUNCHES.count, TM.LAUNCHES.count)
        out = TM.fused_mlp_block(x, vecs[0], vecs[1], w1, vecs[2], w2, vecs[3])
        assert out.shape == (T, D) and out.dtype == BF
        assert (TM.PARTIAL_LAUNCHES.count - before[0], TM.LAUNCHES.count - before[1]) == (k, 0)
        _assert_k6f_chunks(fake_lib.calls[start:], x, w1, w2, T, D, F, k)
    assert not set(fake_lib.names()) & set(WMMA_LAUNCHES)


# the tensor-parallel partial on a rank's shard: DiT-S and DiT-B at --tp 2
# (training and sampling rows), DiT-S's shard at --tp 4, and ragged T
TP_SHAPES = [(131072, 384, 768), (16384, 384, 768), (131072, 768, 1536), (131072, 384, 384),
             (1000, 384, 768)]


@pytest.mark.parametrize("T,D,F", TP_SHAPES)
def test_k6f_tp_partial_is_one_chunk_on_the_wgmma_products(fake_lib, T, D, F):
    """``fused_mlp_partial`` where the ladder has the fused or fwdonly tier:
    one K6f, the LN-prologue product then the partial product's store into
    a new fp32 (T, D), the shard's W2 read in place with its own leading
    dimension."""
    assert tiers.mlp_tier(T, D, F)[0] in ("fused", "fwdonly")
    x, w1, w2 = _arena((T, D), (F, D), (D, F))
    vecs = [torch.empty(n, device="meta") for n in (D, D, F)]
    before = TM.PARTIAL_LAUNCHES.count
    out = TM.fused_mlp_partial(x, vecs[0], vecs[1], w1, vecs[2], w2)
    assert out.shape == (T, D) and out.dtype == torch.float32
    assert TM.PARTIAL_LAUNCHES.count == before + 1
    _assert_k6f_chunks(fake_lib.calls, x, w1, w2, T, D, F, 1, final=False)


# (E, S, D, F): E 2-512 at DiT-S width, S ragged against the 128-row tile
# (192, 320, 1344, 20,480 + 64), DiT-B and DiT-XL widths (the trainers' top-1
# slot rows), E 128 at S 4,096 and E 512 at S 1,024
K10B_SHAPES = [(2, 192, 384, 1536), (8, 20480, 384, 1536), (8, 1344, 384, 1536),
               (16, 320, 384, 1536), (128, 4096, 384, 1536), (512, 1024, 384, 1536),
               (8, 20480, 768, 3072), (16, 20544, 768, 3072), (8, 20480, 1152, 4608),
               (2, 192, 1152, 4608)]


@pytest.mark.parametrize("E,S,D,F", K10B_SHAPES)
def test_k10b_runs_five_expert_products_in_place(fake_lib, E, S, D, F):
    """K10b's chain: the recompute (bias + GELU + gelu', w1 read (K, N)), dW2
    with db2 (the column sums of dO), dh (w2 read K-major, the db1 sums), dW1,
    and dx (w1 read K-major, bf16), each with E and its plan; the slot rows,
    dO and both weights passed where they lie, with no transposed copy."""
    x, dout, w1, w2 = _arena((E, S, D), (E, S, D), (E, D, F), (E, F, D))
    b1, b2 = (torch.empty((E, n), device="meta") for n in (F, D))
    before = TX.BWD_LAUNCHES.count
    grads = TX.expert_ffn_bwd(x, w1, b1, w2, b2, dout)
    assert [tuple(g.shape) for g in grads] == [(E, S, D), (E, D, F), (E, F), (E, F, D), (E, D)]
    assert TX.BWD_LAUNCHES.count == before + 1
    assert fake_lib.names() == ["ddm_wg_expert_nn", "ddm_wg_expert_tn", "ddm_wg_expert_nn",
                                "ddm_wg_expert_tn", "ddm_wg_expert_nn"]
    rec, dw2, dh, dw1, dx = (a for _, a in fake_lib.calls)
    # nn: a, w, bias, dfac, out, out2, ws, colsum, E, T, K, N, ldw, sw, epi, fast, wt, bn,
    # tiles; tn: a, b, ws, dw, cws, colsum, E, T, Ma, Nb, splits, rows, colsum_of_b, bn
    for args, a, w, K, N, ldw, epi, wt in (
            (rec, x, w1, D, F, F, G.NN_BIAS_GELU_GRAD, 0), (dh, dout, w2, D, F, D, G.NN_DGELU, 1),
            (dx, None, w1, F, D, F, G.NN_BF16, 1)):
        plan = G.wg_tile_plan(S, N, H100_SMS, batch=E)
        assert args[1] == w.data_ptr() and (a is None or args[0] == a.data_ptr())
        assert args[8:19] == (E, S, K, N, ldw, D * F, epi, 0, wt, *plan[:2])
        _covers(S, N, plan, 4)
        assert G.wg_smem("nt" if wt else "nn", plan[0], K) <= SMEM
    assert rec[2] is not None and rec[5] is not None  # bias in, gelu' out
    assert dh[3] == rec[5] and dh[6] is not None  # dfac in, db1 partials
    assert dx[0] == dh[4] and dw1[1] == dh[4]  # bf16(dh) feeds dx and dW1
    assert dw2[0] == rec[4] and dw2[1] == dout.data_ptr() and dw1[0] == x.data_ptr()
    for args, Ma, Nb, colsum_of_b in ((dw2, F, D, 1), (dw1, D, F, 0)):
        bn, splits, rows = G.wg_split_plan(S, Ma, Nb, H100_SMS, batch=E)
        assert args[6:14] == (E, S, Ma, Nb, splits, rows, colsum_of_b, bn)
        assert rows % G.WG_BK == 0 and 1 <= splits <= 64 and E * splits <= 65535
        assert (splits - 1) * rows < S <= splits * rows, (Ma, Nb)  # each expert's rows
        assert (args[2] is None) == (splits == 1)  # one split writes dW directly
        assert (args[4] is not None) == bool(colsum_of_b)
        assert G.wg_smem("tn", bn, S) <= SMEM
    assert not set(fake_lib.names()) & set(WMMA_LAUNCHES)


def test_expert_launchers_refuse_what_the_kernels_do_not_take(fake_lib):
    """``expert_nn_wg`` takes the dh and bf16 codes on a transposed weight,
    and adds the fp32 and bias + GELU ones on a (K, N) weight (fast GELU with
    the latter only); ``gemm_partial_wg`` takes the three partial codes;
    ``tma_operand`` refuses a misaligned expert stride. Each refusal comes
    before a launch."""
    a = torch.empty((2, 64, 128), dtype=BF, device="meta")
    w = torch.empty((2, 128, 256), dtype=BF, device="meta")
    for epi, kw in ((G.NN_F32, {"transposed": True}), (G.NN_BIAS_GELU_GRAD, {"transposed": True}),
                    (G.NN_BIAS, {}), (G.NN_BIAS_GELU, {}), (G.NN_BF16, {"fast_gelu": True})):
        with pytest.raises(ValueError):
            G.expert_nn_wg(a, w, epi, **kw)
    with pytest.raises(ValueError):
        G.gemm_partial_wg(a[0], w[0].t(), G.NN_FINAL_BIAS, None)
    with pytest.raises(ValueError):
        G.tma_operand(torch.empty((2, 3, 4), dtype=BF, device="meta")[:, :, :3], "odd",
                      batched=True)
    assert fake_lib.calls == []
    g, dfac = G.expert_nn_wg(a, w, G.NN_BIAS_GELU_GRAD, bias=torch.empty((2, 256), device="meta"),
                             fast_gelu=True)
    assert g.dtype == BF and dfac.dtype == torch.float32 and g.shape == dfac.shape == (2, 64, 256)
    assert fake_lib.calls[-1][1][14:17] == (G.NN_BIAS_GELU_GRAD, 1, 0)
