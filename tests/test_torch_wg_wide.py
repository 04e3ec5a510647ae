"""The F-chunked MLP forward K6f, the tensor-parallel partial's backward
K6b, and the expert FFN's backward K10b and F-chunked forward K10p on the
wgmma products (``ddm_tpu_torch/ops/mlp_block.py`` ``_k6f``, ``_k6b``,
``ops/expert_ffn.py`` ``_k10b``, ``_k10p``; ``ops/gemm.py`` ``*_wg``,
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
  expert's rows exactly; no WMMA launch;
- K10p at every (E, S, D, F) the expert ladder tiers ``("fwdonly", k > 1)``
  (D 768-3072, k 2, 4 and 8, S ragged against 128 too): two expert-coordinate
  launches a chunk, bias + GELU on the W1 column chunk, then the store, add
  or final sum on the W2 row chunk, both read in place, into one fp32 sum;
  no WMMA launch;
- K6b at the tensor-parallel shards (DiT-S, DiT-B and DiT-XL at ``--tp 2``,
  ragged T): the cotangent's cast, then K1b's six launches with no column
  sums on dW2 and no residual to the LayerNorm backward; no WMMA launch.

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


@pytest.fixture()
def apart(monkeypatch):
    """``torch.empty`` and ``torch.empty_like`` on the meta device give each
    new tensor an address of its own in one meta buffer (a new meta tensor's
    data_ptr is 0), so a test can follow each output from the launch that
    writes it to the launches that read it."""
    empty, empty_like = torch.empty, torch.empty_like
    arena = empty(1 << 48, dtype=torch.uint8, device="meta")
    top = [256]

    def on_meta(*size, dtype=None, device=None, **kwargs):
        if torch.device(device if device is not None else "cpu").type != "meta":
            return empty(*size, dtype=dtype, device=device, **kwargs)
        shape = torch.Size(size[0] if len(size) == 1 and not isinstance(size[0], int) else size)
        dtype = dtype or torch.get_default_dtype()
        n = shape.numel() * dtype.itemsize
        at, top[0] = top[0], top[0] + -(-n // 256) * 256 + 256
        return arena[at:at + n].view(dtype).view(shape)

    def like(t, dtype=None, **kwargs):
        if not t.is_meta:
            return empty_like(t, dtype=dtype, **kwargs)
        return on_meta(t.shape, dtype=dtype or t.dtype, device="meta")

    monkeypatch.setattr(torch, "empty", on_meta)
    monkeypatch.setattr(torch, "empty_like", like)


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
    and adds the fp32, the two bias + GELU and the two sum codes on a (K, N)
    weight (fast GELU with the GELU ones only; the add and the final sum
    with an accumulator, each bias code with a bias); ``gemm_partial_wg``
    takes the three partial codes; ``tma_operand`` refuses a misaligned
    expert stride. Each refusal comes before a launch."""
    a = torch.empty((2, 64, 128), dtype=BF, device="meta")
    w = torch.empty((2, 128, 256), dtype=BF, device="meta")
    bias = torch.empty((2, 256), device="meta")
    acc = torch.empty((2, 64, 256), device="meta")
    for epi, kw in ((G.NN_F32, {"transposed": True}), (G.NN_BIAS_GELU_GRAD, {"transposed": True}),
                    (G.NN_BIAS, {}), (G.NN_BIAS, {"bias": bias}),
                    (G.NN_BF16, {"fast_gelu": True}),
                    (G.NN_BIAS_GELU, {"transposed": True, "bias": bias}),
                    (G.NN_ADD, {"transposed": True, "acc": acc}),
                    (G.NN_FINAL_BIAS, {"transposed": True, "acc": acc, "bias": bias}),
                    (G.NN_ADD, {}), (G.NN_FINAL_BIAS, {"bias": bias}),
                    (G.NN_FINAL_BIAS, {"acc": acc}), (G.NN_BIAS_GELU, {}),
                    (G.NN_BF16, {"acc": acc}), (G.NN_ADD, {"acc": acc[:, :32]}),
                    (G.NN_ADD, {"acc": acc.to(BF)})):
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
    g = G.expert_nn_wg(a, w, G.NN_BIAS_GELU, bias=bias, fast_gelu=True)
    assert g.dtype == BF and g.shape == (2, 64, 256)
    assert fake_lib.calls[-1][1][14:17] == (G.NN_BIAS_GELU, 1, 0)
    for epi in (G.NN_F32, G.NN_ADD):
        assert G.expert_nn_wg(a, w, epi, acc=acc) is acc
    out = G.expert_nn_wg(a, w, G.NN_FINAL_BIAS, bias=bias, acc=acc)
    assert out.dtype == BF and out.shape == (2, 64, 256)
    assert [c[1][14] for c in fake_lib.calls[-3:]] == [G.NN_F32, G.NN_ADD, G.NN_FINAL_BIAS]


def _k10p_shapes():
    """``{(D, F): [(E, S, k), ...]}`` over D 768-3072 (multiples of 128) at
    MLP ratios 1-4 and 8/3, for each of SLOTS the expert ladder tiers
    ``("fwdonly", k > 1)``."""
    out = {}
    for D in range(768, 3073, 128):
        for F in sorted({D, 2 * D, 3 * D, 4 * D, D * 8 // 3 // 128 * 128}):
            for E, S in SLOTS:
                tier = tiers.expert_tier(E, S, D, F)
                if tier is not None and tier[0] == "fwdonly" and tier[1] > 1:
                    out.setdefault((D, F), []).append((E, S, tier[1]))
    return out


# (E, S): the trainers' top-1 and top-2 slot rows (8 experts), and slot rows
# ragged against the 128-row tile (200, 1344, 20,544)
SLOTS = ((8, 20480), (8, 40960), (8, 20544), (8, 1344), (2, 200))
K10P = _k10p_shapes()


def test_k10p_shapes_span_the_expert_ladders_chunked_tier():
    """The cases reach from D 768 (DiT-B's MoE, k 2) to D 3072 (k 8), with
    the XL MoE (D 1152, F 4608, k 4), every k, and ragged S at each k."""
    ks = {k for cases in K10P.values() for *_, k in cases}
    assert ks == {2, 4, 8}
    assert (8, 20480, 2) in K10P[(768, 3072)] and (8, 20480, 4) in K10P[(1152, 4608)]
    assert (2, 200, 8) in K10P[(3072, 3072)]
    assert min(D for D, _ in K10P) == 768 and max(D for D, _ in K10P) == 3072
    for k in ks:
        assert any(S % 128 and kk == k for cases in K10P.values() for _, S, kk in cases)


@pytest.mark.parametrize("D,F", sorted(K10P))
def test_k10p_chunks_reach_the_expert_products_in_place(fake_lib, apart, D, F):
    """Through ``expert_ffn`` at every (E, S) of SLOTS the ladder tiers
    ``("fwdonly", k > 1)``: k chunks of two ``ddm_wg_expert_nn`` launches,
    bias + GELU (no gelu') on the W1 column chunk, then the W2 row chunk
    into one fp32 (E, S, D) sum with the store, add and final codes in chunk
    order; both chunks passed where they lie (base, row stride, expert
    stride), the first product's output the second's input; tile plans that
    cover each expert's output; one K10p counted a chunk, no K10f, no WMMA
    product."""
    for E, S, k in K10P[(D, F)]:
        start = len(fake_lib.calls)
        x, w1, w2 = _arena((E, S, D), (E, D, F), (E, F, D))
        b1, b2 = torch.empty((E, F), device="meta"), torch.empty((E, D), device="meta")
        before = (TX.PARTIAL_LAUNCHES.count, TX.LAUNCHES.count)
        out = TX.expert_ffn(x, w1, b1, w2, b2)
        assert out.shape == (E, S, D) and out.dtype == BF
        assert (TX.PARTIAL_LAUNCHES.count - before[0], TX.LAUNCHES.count - before[1]) == (k, 0)
        calls = fake_lib.calls[start:]
        assert [n for n, _ in calls] == ["ddm_wg_expert_nn"] * (2 * k)
        fc, acc = F // k, None
        # a, w, bias, dfac (the sum read), out, out2, ws, colsum, E, T, K, N, ldw, sw, epi,
        # fast, wt, bn, tiles
        for c in range(k):
            (_, h), (_, s) = calls[2 * c:2 * c + 2]
            plan = G.wg_tile_plan(S, fc, H100_SMS, batch=E)
            assert h[0] == x.data_ptr() and h[1] == w1.data_ptr() + c * fc * 2
            assert h[8:19] == (E, S, D, fc, F, D * F, G.NN_BIAS_GELU, 0, 0, *plan[:2])
            assert h[2] is not None and h[3] is None and h[5] is None  # b1 in, no gelu' out
            _covers(S, fc, plan, 4)
            assert G.wg_smem("nn", plan[0], D) <= SMEM
            epi = G.NN_F32 if c == 0 else G.NN_FINAL_BIAS if c == k - 1 else G.NN_ADD
            plan = G.wg_tile_plan(S, D, H100_SMS, batch=E)
            assert s[0] == h[4] and s[1] == w2.data_ptr() + c * fc * D * 2  # in place, ld D
            assert s[8:19] == (E, S, fc, D, D, F * D, epi, 0, 0, *plan[:2])
            _covers(S, D, plan, 4)
            assert G.wg_smem("nn", plan[0], fc) <= SMEM
            acc = s[4] if acc is None else acc  # chunk 0 stores the sum
            assert s[3] == (None if c == 0 else acc)  # later chunks read it
            assert (s[4] == acc) == (epi != G.NN_FINAL_BIAS)  # and add into it in place
            assert (s[2] is not None) == (epi == G.NN_FINAL_BIAS)  # b2, last
            assert len({h[4], acc}) == 2 and s[5] is None and s[6] is None
        assert calls[-1][1][4] == out.data_ptr()
    assert not set(fake_lib.names()) & set(WMMA_LAUNCHES)


# the tensor-parallel shards of K6b: TP_SHAPES, DiT-XL's at --tp 2, ragged T at its width
K6B_SHAPES = TP_SHAPES + [(131072, 1152, 2304), (4133, 1152, 2304)]


@pytest.mark.parametrize("T,D,F", K6B_SHAPES)
def test_k6b_is_k1bs_chain_without_the_residual(fake_lib, apart, T, D, F):
    """``mlp_partial_bwd`` for an fp32 cotangent: its cast to bf16, then the
    recompute (g, gelu'(h), y), dW2 with no column-sum buffer (no db2), dh
    with db1, dW1 and dy in fp32 on the wgmma products, and the LayerNorm
    backward with a null residual; each output passed to the launches that
    read it, each plan the shapes', one K6b counted, no WMMA product."""
    x, w1, w2 = _arena((T, D), (F, D), (D, F))
    do = torch.empty((T, D), device="meta")
    sc, bi, b1 = (torch.empty(n, device="meta") for n in (D, D, F))
    before = (TM.PARTIAL_BWD_LAUNCHES.count, TM.BWD_LAUNCHES.count)
    grads = TM.mlp_partial_bwd(x, sc, bi, w1, b1, w2, do)
    assert [tuple(g.shape) for g in grads] == [(T, D), (D,), (D,), (F, D), (F,), (D, F)]
    assert [g.dtype for g in grads] == [BF] + [torch.float32] * 5
    assert (TM.PARTIAL_BWD_LAUNCHES.count - before[0], TM.BWD_LAUNCHES.count - before[1]) == (1, 0)
    assert fake_lib.names() == ["ddm_cast_bf16", "ddm_wg_ln_gemm", "ddm_wg_expert_tn",
                                "ddm_wg_expert_nn", "ddm_wg_expert_tn", "ddm_wg_expert_nn",
                                "ddm_ln_bwd"]
    cast, rec, dw2, dh, dw1, dy, ln = (a for _, a in fake_lib.calls)
    dob = cast[1]
    assert cast[0] == do.data_ptr() and cast[2] == T * D
    # ln_gemm: x, scale, bias, w, b, out, out2, y, T, K, N, epi, fast, bn, tiles
    assert rec[0] == x.data_ptr() and rec[3] == w1.data_ptr() and None not in rec[5:8]
    assert rec[8:15] == (T, D, F, G.EPI_GELU_GRAD, 0,
                         *G.wg_tile_plan(T, F, H100_SMS, most=8)[:2])
    assert G.wg_smem("ln_gemm", G.wg_block_n(F), D) <= SMEM
    # tn: a, b, ws, dw, cws, colsum, E, T, Ma, Nb, splits, rows, colsum_of_b, bn
    for args, a, b, Ma, Nb in ((dw2, dob, rec[5], D, F), (dw1, dh[4], rec[7], F, D)):
        bn, splits, rows = G.wg_split_plan(T, Ma, Nb, H100_SMS)
        assert args[:2] == (a, b) and args[4] is None and args[5] is None  # no column sums
        assert args[6:14] == (1, T, Ma, Nb, splits, rows, 0, bn)
        assert (args[2] is None) == (splits == 1)
    # nn: a, w, bias, dfac, out, out2, ws, colsum, E, T, K, N, ldw, sw, epi, fast, wt, bn, tiles
    for args, a, w, K, N, epi in ((dh, dob, w2, D, F, G.NN_DGELU), (dy, dh[4], w1, F, D, G.NN_F32)):
        assert args[:2] == (a, w.data_ptr())
        assert args[8:19] == (1, T, K, N, N, 0, epi, 0, 0, *G.wg_tile_plan(T, N, H100_SMS)[:2])
    assert dh[3] == rec[6] and dh[6] is not None and dh[7] is not None  # gelu' in, db1 out
    # ln_bwd: x, dy, dres, scale, dx, partial, sums, T, D
    assert ln[:4] == (x.data_ptr(), dy[4], None, rec[1]) and ln[7:9] == (T, D)
    assert not set(fake_lib.names()) & set(WMMA_LAUNCHES)
