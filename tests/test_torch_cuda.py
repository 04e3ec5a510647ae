"""The CUDA kernels K1-K4, K6f, K6b, K7-K9 and K10-K12 against their plain versions, on the
card, at head widths off 16 (Dh 8, 24, 40, 72), at DiT-XL's D 1152, with the fast GELU, the
MLP half-block past D 1344 (the streamed LN-prologue GEMM, D 1408-4096), and the streamed
attention cores past 227 KB of shared memory (Dh up to 3712), bit for bit the resident ones;
K1f's and K1b's wgmma chains at ragged T and D 64-1536 (y bit for bit the WMMA kernel's),
K2f's and K2b's at D 64-1344 (the recompute's qkv the forward's bits, no WMMA product on
any attention path), K6f's chunks (D 1024-4096) and K10b's five products on the wgmma ring's
expert coordinate (each expert's dW1 and dx the product at one expert's bits; K1b and K2b the
same bits with their products' operands passed as one expert explicitly), K10p's chunks (D
768-3072) and K6b (the --tp 2 shards of DiT-S, DiT-B and DiT-XL) on the same ring with no WMMA
product, the DiT tail
X4f/X4b at every DiT path's width, X2f bit for bit the
WMMA-composed K2f -> MLP pair, X1's phase-batched cores bit for bit K2's, X3's ablations
of K2b's chain, and the registers designs of the forward core and of K8f and K8b, the
narrow heads (Dh 4, 8, 16) included.

Every test here is marked ``cuda`` and skips on a host without a GPU. The
file imports no JAX (the machine with the card has none), so it runs there
without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import attention_ablate as TAB  # noqa: E402
from ddm_tpu_torch.ops import energy as TE  # noqa: E402
from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402
from ddm_tpu_torch.ops import flash as TF  # noqa: E402
from ddm_tpu_torch.ops import ln_dense as TLD  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import moe_dispatch as TD  # noqa: E402
from ddm_tpu_torch.ops import phase_softmax as TPS  # noqa: E402
from ddm_tpu_torch.ops import tiers as TT  # noqa: E402
from ddm_tpu_torch.ops import whole_block as TW  # noqa: E402

# bf16 outputs: the kernel and the plain version round at the same points,
# but fp32 sums taken in another order can flip a rounding, which moves an
# output by one bf16 unit: 2^-6 at |out| < 4, 2^-5 below 8.
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)
# fp32 weight, bias and LN gradients: sums over T rows of products of
# bf16-rounded operands, where one flipped rounding upstream (a bf16 unit of
# dh or dqkv) moves single entries; the bulk must agree to fp32 sums.
GRAD_MAX_REL, GRAD_FROB_REL = 1e-2, 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlp_inputs(T, D, F, seed=0):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((T, D)).astype(np.float32),
        scale=(1 + 0.1 * r.standard_normal(D)).astype(np.float32),
        bias=(0.1 * r.standard_normal(D)).astype(np.float32),
        w1=(D ** -0.5 * r.standard_normal((F, D))).astype(np.float32),
        b1=(0.1 * r.standard_normal(F)).astype(np.float32),
        w2=(F ** -0.5 * r.standard_normal((D, F))).astype(np.float32),
        b2=(0.1 * r.standard_normal(D)).astype(np.float32),
    )


def _attn_inputs(B, N, D, seed=1):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((B, N, D)).astype(np.float32),
        scale=(1 + 0.1 * r.standard_normal(D)).astype(np.float32),
        bias=(0.1 * r.standard_normal(D)).astype(np.float32),
        wqkv=(D ** -0.5 * r.standard_normal((3 * D, D))).astype(np.float32),
        bqkv=(0.1 * r.standard_normal(3 * D)).astype(np.float32),
        wproj=(D ** -0.5 * r.standard_normal((D, D))).astype(np.float32),
        bproj=(0.1 * r.standard_normal(D)).astype(np.float32),
    )


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "`python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`")
    return torch.device("cuda")


def _on(device, inputs):
    a = {k: _t(v).to(device) for k, v in inputs.items()}
    a["x"] = a["x"].to(torch.bfloat16)
    return tuple(a.values())


def _assert_grads_close(got, want):
    dx, *rest = got
    torch.testing.assert_close(dx.float(), want[0].float(), **BF16_TOL)
    for i, (g, w) in enumerate(zip(rest, want[1:]), start=1):
        err = (g - w).abs()
        assert float(err.max()) <= GRAD_MAX_REL * float(w.abs().max()), i
        assert float(torch.linalg.norm(g - w)) <= GRAD_FROB_REL * float(torch.linalg.norm(w)), i


def _grads_through_autograd(fn, args, extra, dout):
    leaves = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*leaves, *extra)
    out.backward(dout)
    return [a.grad for a in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F", [(16384, 384, 1536), (1000, 128, 512)])
def test_k1_kernel_matches_plain_on_the_card(cuda_device, T, D, F):
    args = _on(cuda_device, _mlp_inputs(T, D, F))
    before = TM.LAUNCHES.count
    with torch.inference_mode():
        got = TM.fused_mlp_block(*args)
        torch.cuda.synchronize()
        want = TM.mlp_block_reference(*args)
    assert TM.LAUNCHES.count == before + 1
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F", [(16384, 384, 1536), (1000, 128, 512)])
def test_k1_backward_kernel_matches_plain_on_the_card(cuda_device, T, D, F):
    args = _on(cuda_device, _mlp_inputs(T, D, F))
    dout = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(2),
                       device=cuda_device).to(torch.bfloat16)
    before = TM.BWD_LAUNCHES.count
    got = _grads_through_autograd(TM.fused_mlp_block, args, (), dout)
    again = _grads_through_autograd(TM.fused_mlp_block, args, (), dout)
    torch.cuda.synchronize()
    assert TM.BWD_LAUNCHES.count == before + 2
    want = TM.mlp_block_bwd_reference(*args, dout)
    _assert_grads_close(got, want)
    for g, h in zip(got, again):  # deterministic: no atomics, fixed sum orders
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("D,F", [(64, 256), (384, 1536), (768, 3072), (1152, 4608),
                                 (1536, 6144)])
@pytest.mark.parametrize("T", [8, 100, 16384 + 37])
def test_k1_wgmma_chains_match_plain_on_the_card(cuda_device, T, D, F, fast):
    """K1f's and K1b's chains on the wgmma products (``csrc/gemm_wg.cu``),
    called directly at any width they take (the tiers send D 1152 and 1536
    to K6f forward): ragged T, the erf and the sigmoid GELU, against the
    plain versions by the bf16 and gradient rules; a second K1b call is
    bit-identical (split-K in fixed row ranges, no atomics)."""
    args = _on(cuda_device, _mlp_inputs(T, D, F, seed=70))
    dout = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(71),
                       device=cuda_device).to(torch.bfloat16)
    before = (TM.LAUNCHES.count, TM.BWD_LAUNCHES.count)
    with torch.no_grad():
        got = TM._k1f(*args, fast_gelu=fast)
        grads = TM._k1b(*args, dout, fast_gelu=fast)
        again = TM._k1b(*args, dout, fast_gelu=fast)
        torch.cuda.synchronize()
    assert (TM.LAUNCHES.count - before[0], TM.BWD_LAUNCHES.count - before[1]) == (1, 2)
    _assert_bf16_rule(got, TM.mlp_block_reference(*args, fast_gelu=fast))
    _assert_grads_close(grads, TM.mlp_block_bwd_reference(*args, dout, fast_gelu=fast))
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F", [(100, 384, 1536), (16384 + 37, 384, 1536),
                                   (1000, 1152, 4608), (300, 4096, 4096), (513, 1408, 1408)])
def test_wgmma_ln_product_keeps_ln_gemms_y_on_the_card(cuda_device, T, D, F):
    """The wgmma LN-prologue product takes the row statistics in ln_gemm's
    order, so y = bf16(LN(x)) is the WMMA kernel's bit for bit; gelu'(h)
    agrees with the WMMA kernel's to fp32 sums taken in another order, and g
    by the bf16 rule."""
    x, scale, bias, w1, b1, _, _ = _on(cuda_device, _mlp_inputs(T, D, F, seed=72))
    w1 = w1.to(torch.bfloat16)
    g = TM.gemm
    with torch.no_grad():
        out, grad, y = g.ln_gemm_wg(x, scale, bias, w1, b1, g.EPI_GELU_GRAD, with_y=True)
        out0, grad0, y0 = g.ln_gemm(x, scale, bias, w1, b1, g.EPI_GELU_GRAD, with_y=True)
        torch.cuda.synchronize()
    assert torch.equal(y, y0)
    _assert_bf16_rule(out, out0)
    assert float((grad - grad0).abs().max()) <= 1e-4 * float(grad0.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", [(256, 64, 384, 6), (5, 128, 256, 4), (3, 16, 128, 2),
                                     (256, 64, 1152, 16), (256, 64, 384, 16),
                                     (16, 64, 128, 16)])
def test_k2_kernel_matches_plain_on_the_card(cuda_device, B, N, D, H):
    args = _on(cuda_device, _attn_inputs(B, N, D))
    before = TA.LAUNCHES.count
    with torch.inference_mode():
        got = TA.fused_attention_block(*args, H)
        torch.cuda.synchronize()
        want = TA.attention_block_reference(*args, H)
    assert TA.LAUNCHES.count == before + 1
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", [(256, 64, 384, 6), (3, 16, 128, 2), (256, 64, 384, 16),
                                     (8, 256, 384, 16)])
def test_k2_backward_kernel_matches_plain_on_the_card(cuda_device, B, N, D, H):
    args = _on(cuda_device, _attn_inputs(B, N, D))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device).to(torch.bfloat16)
    before = TA.BWD_LAUNCHES.count
    got = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    again = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    torch.cuda.synchronize()
    assert TA.BWD_LAUNCHES.count == before + 2
    want = TA.attention_block_bwd_reference(*args, H, dout)
    _assert_grads_close(got, want)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(2048, 64, 6, 64), (64, 64, 16, 64), (3, 16, 2, 64)])
def test_backward_core_att_is_the_forward_cores_on_the_card(cuda_device, B, N, H, Dh):
    """K2b and K4 share one attention core, which writes att from its fp32
    P: the one-block design's (forced) bit for bit the resident forward
    core's output on the same qkv; the plan's picks, the registers designs
    at these widths (sums in another order), within the bf16 rule of both."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    qkv = torch.randn(B, N, 3 * H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    datt = torch.randn(B, N, H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    att, dqkv = TA._core_bwd_att(qkv, datt, H)
    earlier = TA._core_bwd_att(qkv, datt, H, "one-block")[0]
    assert torch.equal(earlier, TA._k2_core(qkv, H, "resident"))
    _assert_bf16_rule(TA._k2_core(qkv, H), att)
    _assert_bf16_rule(att, earlier)
    want = TA.attention_core_bwd_att_reference(*qkv.split(H * Dh, dim=-1), datt, H)
    _assert_bf16_rule(att, want[0])
    _assert_bf16_rule(dqkv, torch.cat(want[1:], dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(2048, 64, 6, 64), (64, 64, 16, 64), (3, 16, 2, 64),
                                      (256, 64, 16, 24), (64, 64, 16, 72), (64, 48, 8, 40),
                                      (16, 32, 4, 128)])
def test_fused_backward_core_att_is_the_registers_forwards_on_the_card(cuda_device, B, N, H,
                                                                         Dh):
    """At N <= 64 and padded heads up to 128 the plans pick the fused
    registers backward and the registers forward; the att the fused block
    writes (which K2b's dWproj reads) is the forward core's output on the
    same qkv bit for bit."""
    assert TA.core_plan(N, Dh, backward=True)["design"] == "registers-fused"
    assert TA.core_plan(N, Dh)["design"] == "registers"
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    qkv = torch.randn(B, N, 3 * H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    datt = torch.randn(B, N, H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    assert torch.equal(TA._core_bwd_att(qkv, datt, H)[0], TA._k2_core(qkv, H))


# K2's chains on the wgmma products at each width class: ragged column tiles
# (D 64, 320), DiT-S (384), DiT-B (768), DiT-L (1024: 256-wide tiles), DiT-XL
# (1152, Dh 72) and the widest (1344); ragged T (B 3 x N 16), N 64 and 256
K2_WG_WIDTHS = [(64, 1), (320, 5), (384, 6), (768, 12), (1024, 16), (1152, 16), (1344, 21)]
K2_WG_TOKENS = [(3, 16), (5, 64), (2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", K2_WG_TOKENS)
@pytest.mark.parametrize("D,H", K2_WG_WIDTHS)
def test_k2_wgmma_chains_match_plain_on_the_card(cuda_device, B, N, D, H):
    """K2f's and K2b's chains on the wgmma products (``csrc/gemm_wg.cu``),
    called directly at every width class they take (the tiers send some of
    these to the third rung, which runs the same chains): against the plain
    versions by the bf16 and gradient rules; a second K2b call is
    bit-identical (split-K in fixed row ranges, no atomics)."""
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=80))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(81),
                       device=cuda_device).to(torch.bfloat16)
    before = (TA.LAUNCHES.count, TA.BWD_LAUNCHES.count)
    with torch.no_grad():
        got = TA._k2f(*args, H)
        grads = TA._k2b(*args, H, dout)
        again = TA._k2b(*args, H, dout)
        torch.cuda.synchronize()
    assert (TA.LAUNCHES.count - before[0], TA.BWD_LAUNCHES.count - before[1]) == (1, 2)
    _assert_bf16_rule(got, TA.attention_block_reference(*args, H))
    _assert_grads_close(grads, TA.attention_block_bwd_reference(*args, H, dout))
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", [(2048, 64, 384, 6), (3, 16, 320, 5), (64, 64, 1152, 16)])
def test_k2b_recompute_is_k2fs_qkv_on_the_card(cuda_device, B, N, D, H):
    """The backward's qkv recompute is the forward's qkv product: the same
    wgmma kernel and plan (a function of the shapes and the SM count), so
    the same bits."""
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=82))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(83),
                       device=cuda_device).to(torch.bfloat16)
    seen = {}

    def core(qkv):
        seen["forward"] = qkv.clone()
        return TA._k2_core(qkv, H), None

    def core_bwd(qkv, datt):
        seen["recompute"] = qkv.clone()
        return TA._core_bwd_att(qkv, datt, H)

    with torch.no_grad():
        TA._fwd_chain(*args, core)
        TA._bwd_chain(*args, dout, core_bwd)
        torch.cuda.synchronize()
    assert torch.equal(seen["forward"], seen["recompute"])


def _refuse_wmma(*args, **kwargs):
    raise AssertionError("a WMMA product ran on a wgmma chain")


WMMA_LAUNCHERS = ("ln_gemm", "gemm_residual", "gemm_nn", "gemm_tn", "gemm_partial")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["K2", "K4", "rung3 K7", "rung3 K8"])
def test_attention_paths_launch_no_wmma_product_on_the_card(cuda_device, monkeypatch, path):
    """With the WMMA launchers of ``ops/gemm.py`` made to raise, K2f and K2b
    (DiT-S/4), K4 (DiT-L), and the third rung around K7 (DiT-L at N 256) and
    K8 (N 1024, Dh 64) still pass their card tests: their chains launch only
    the wgmma products (and the cores and ``ln_bwd``), with no fallback."""
    for name in WMMA_LAUNCHERS:
        monkeypatch.setattr(TA.gemm, name, _refuse_wmma)
    if path == "K2":
        test_k2_kernel_matches_plain_on_the_card(cuda_device, 256, 64, 384, 6)
        test_k2_backward_kernel_matches_plain_on_the_card(cuda_device, 256, 64, 384, 6)
    elif path == "K4":
        test_k4_split_backward_matches_plain_on_the_card(cuda_device, monkeypatch, 256, 64,
                                                         1024, 16, False)
    elif path == "rung3 K7":
        test_rung3_half_block_matches_plain_on_the_card(cuda_device, 8, 256, 1024, 16, "K7")
    else:
        test_rung3_half_block_matches_plain_on_the_card(cuda_device, 2, 1024, 384, 6, "K8")


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,D", [(256, 8, 3072), (8, 3, 128)])
@pytest.mark.parametrize("beta", [0.1, 2.0])
def test_k3_kernels_match_plain_on_the_card(cuda_device, B, m, D, beta):
    r = np.random.default_rng(4)
    xh = _t(r.standard_normal((B, m, D)).astype(np.float32)).to(cuda_device)
    x0 = _t(r.standard_normal((B, D)).astype(np.float32)).to(cuda_device)
    gconf, ginter = (torch.tensor(v, device=cuda_device) for v in (0.7, -0.3))
    f_before, b_before = TE.FWD_LAUNCHES.count, TE.BWD_LAUNCHES.count
    leaves = [xh.clone().requires_grad_(), x0.clone().requires_grad_()]
    conf, inter = TE.fused_energy_terms(*leaves, beta)
    torch.autograd.backward((conf, inter), (gconf, ginter))
    torch.cuda.synchronize()
    assert (TE.FWD_LAUNCHES.count, TE.BWD_LAUNCHES.count) == (f_before + 1, b_before + 1)
    want_c, want_i = TE.energy_terms_reference(xh, x0, beta)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(inter, want_i, rtol=1e-5, atol=0)
    for got, want in zip((leaves[0].grad, leaves[1].grad),
                         TE.energy_terms_bwd_reference(xh, x0, beta, gconf, ginter)):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(64, 128, device=cuda_device)
    vec, w = torch.zeros(128, device=cuda_device), torch.zeros(512, 128, device=cuda_device)
    b1, w2 = torch.zeros(512, device=cuda_device), torch.zeros(128, 512, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        TM.fused_mlp_block(x, vec, vec, w, b1, w2, vec)
    with pytest.raises(TypeError, match="bf16"):
        TM.fused_mlp_block(x.requires_grad_(), vec, vec, w, b1, w2, vec)
    wqkv, bqkv = torch.zeros(384, 128, device=cuda_device), torch.zeros(384, device=cuda_device)
    wproj = torch.zeros(128, 128, device=cuda_device)
    tokens = torch.zeros(2, 24, 128, device=cuda_device, dtype=torch.bfloat16)
    assert TT.attention_tier(2, 24, 128, 2) == "fused"
    # the JAX gate takes N % 8 == 0; the cores take N % 16 == 0, which every
    # square token count that is a multiple of 8 is (no image gives N = 24)
    with pytest.raises(NotImplementedError, match="N=24"):
        TA.fused_attention_block(tokens, vec, vec, wqkv, bqkv, wproj, vec, 2)
    q = torch.zeros(2, 24, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="N=24"):
        TA.attention_core_fwd(q, q, q, 2)
    xh, x0 = torch.zeros(4, 1, 128, device=cuda_device), torch.zeros(4, 128, device=cuda_device)
    with pytest.raises(ValueError, match="m must be >= 2"):
        TE.fused_energy_terms(xh, x0, 0.1)


_ENERGY_COUNTERS = (TE.FWD_LAUNCHES, TE.BWD_LAUNCHES, TE.STREAM_FWD_LAUNCHES,
                    TE.STREAM_BWD_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,D", [(5, 3, 128), (4, 17, 128), (2, 72, 128)])
def test_energy_takes_its_plain_version_where_the_jax_gate_does(cuda_device, B, m, D):
    """(5, 3, 128) fails the JAX K3 gate (an image block of 1 that is neither
    8 nor B), m = 17 and m = 72 both gates: the JAX package runs its jnp path
    and the port its plain version, on the device: no launch."""
    assert TE.energy_route(B, m, D) is None
    r = np.random.default_rng(5)
    xh = _t(r.standard_normal((B, m, D)).astype(np.float32)).to(cuda_device)
    x0 = _t(r.standard_normal((B, D)).astype(np.float32)).to(cuda_device)
    before = [c.count for c in _ENERGY_COUNTERS]
    got = TE.fused_energy_terms(xh, x0, 0.1)
    assert [c.count for c in _ENERGY_COUNTERS] == before
    for g, w in zip(got, TE.energy_terms_reference(xh, x0, 0.1)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,D,route", [(256, 32, 3072, "K9"), (4, 24, 128, "K9"),
                                         (2, 64, 256, "K9"), (64, 4, 12288, "K3"),
                                         (8, 8, 12288, "K3")])
@pytest.mark.parametrize("beta", [0.1, 2.0])
def test_d_tiled_energy_kernels_match_plain_on_the_card(cuda_device, B, m, D, route, beta):
    """K9f/K9b, and K3 where one image's rows exceed a block's shared memory,
    against the route's plain versions: the values to 1e-5 relative, the
    gradients to 1e-4 of their largest entry; a second backward
    bit-identical."""
    assert TE.energy_route(B, m, D) == route
    r = np.random.default_rng(17)
    xh = _t(r.standard_normal((B, m, D)).astype(np.float32)).to(cuda_device)
    x0 = _t(r.standard_normal((B, D)).astype(np.float32)).to(cuda_device)
    gconf, ginter = (torch.tensor(v, device=cuda_device) for v in (0.7, -0.3))
    before = [c.count for c in _ENERGY_COUNTERS]
    leaves = [xh.clone().requires_grad_(), x0.clone().requires_grad_()]
    conf, inter = TE.fused_energy_terms(*leaves, beta)
    torch.autograd.backward((conf, inter), (gconf, ginter))
    again = TE.energy_terms_bwd(xh, x0, beta, gconf, ginter)
    torch.cuda.synchronize()
    k3 = route == "K3"
    assert [c.count - n for c, n in zip(_ENERGY_COUNTERS, before)] == (
        [1, 2, 0, 0] if k3 else [0, 0, 1, 2])
    assert torch.equal(again[0], leaves[0].grad) and torch.equal(again[1], leaves[1].grad)
    fwd = TE.energy_terms_reference if k3 else TE.energy_terms_stream_reference
    bwd = TE.energy_terms_bwd_reference if k3 else TE.energy_terms_stream_bwd_reference
    want_c, want_i = fwd(xh, x0, beta)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=0)
    torch.testing.assert_close(inter, want_i, rtol=1e-5, atol=0)
    for got, want in zip((leaves[0].grad, leaves[1].grad), bwd(xh, x0, beta, gconf, ginter)):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _assert_partial_rule(got, plain, args, axes):
    """An fp32 partial (K6f, K10p): relative Frobenius error within 1e-4, or
    within twice the plain version's own spread when its fp32 sums run in
    another order. ``axes(args, pd, pf)`` returns the plain version's
    arguments with the feature axis permuted by ``pd`` and the hidden axis by
    ``pf``; its output comes back with its last axis permuted by ``pd``."""
    want = plain(*args)
    D, F = args[0].shape[-1], args[-1].shape[-2 if args[-1].dim() == 3 else -1]
    gen = torch.Generator(device=want.device).manual_seed(16)
    pd, pf = (torch.randperm(n, generator=gen, device=want.device) for n in (D, F))
    reordered = plain(*axes(args, pd, pf))[..., torch.argsort(pd)]
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))  # noqa: E731
    assert rel(got, want) <= max(1e-4, 2 * rel(reordered, want))


def _assert_bf16_rule(got, want):
    """Two bf16 units in the last place at the largest magnitude of ``want``
    (one flipped rounding of a sum taken in another order) and a mean error
    far below one unit."""
    top = float(want.float().abs().max())
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= 2.0 * 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)
    assert float(err.mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H", [(2, 1024, 6), (1, 2048, 3), (3, 128, 2)])
def test_k8_kernels_match_plain_on_the_card(cuda_device, B, N, H):
    """K8f and K8b on q, k, v read in place from a [q | k | v] buffer, against
    the plain versions on the same inputs; the backward twice, bit-identical."""
    r = np.random.default_rng(6)
    D = 64 * H
    qkv = _t(r.standard_normal((B, N, 3 * D)).astype(np.float32)).to(cuda_device)
    q, k, v = qkv.to(torch.bfloat16).split(D, dim=-1)
    do = _t(r.standard_normal((B, N, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    before = (TF.FWD_LAUNCHES.count, TF.BWD_LAUNCHES.count)
    o, lse = TF.flash_attention_fwd(q, k, v, H)
    grads = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    again = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    assert (TF.FWD_LAUNCHES.count, TF.BWD_LAUNCHES.count) == (before[0] + 1, before[1] + 2)
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    want = TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)
    for g, h, w in zip(grads, again, want):
        assert torch.equal(g, h)  # no atomics, fixed loop orders
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
def test_k8_through_autograd_on_separate_tensors(cuda_device):
    r = np.random.default_rng(7)
    q, k, v = (_t(r.standard_normal((2, 1024, 128)).astype(np.float32)).to(cuda_device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.ones((2, 1024, 128), device=cuda_device, dtype=torch.bfloat16)
    TF.flash_attention(q, k, v, 2).backward(do)
    o, lse = TF.flash_attention_reference(q.detach(), k.detach(), v.detach(), 2)
    want = TF.flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(), o, lse, do, 2)
    for g, w in zip((q.grad, k.grad, v.grad), want):
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
def test_long_attention_block_matches_plain_on_the_card(cuda_device):
    """N = 1024: the third rung around K8 (the qkv GEMM, K8 and the
    projection GEMM), forward and all seven gradients, against its plain
    version around the plain K8."""
    B, N, D, H = 2, 1024, 384, 6
    assert TT.core_tier(B, N, D, H) == "K8"
    args = _on(cuda_device, _attn_inputs(B, N, D))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(8),
                       device=cuda_device).to(torch.bfloat16)
    counters = (("K2f", TA.LAUNCHES), ("K2b", TA.BWD_LAUNCHES), ("K7f", TA.CORE_LAUNCHES),
                ("K7b", TA.CORE_BWD_LAUNCHES), ("K8f", TF.FWD_LAUNCHES), ("K8b", TF.BWD_LAUNCHES))
    before = {n: c.count for n, c in counters}
    with torch.inference_mode():
        got = TA.fused_attention_block(*args, H)
    want = TA.rung3_block_reference(*args, H, "K8")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    grads = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    again = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    torch.cuda.synchronize()
    after = {n: c.count for n, c in counters}
    assert {n: after[n] - before[n] for n in after} == {"K2f": 0, "K2b": 0, "K7f": 0, "K7b": 0,
                                                        "K8f": 3, "K8b": 2}
    for g, h in zip(grads, again):
        assert torch.equal(g, h)
    # K8f rounds p against a running max where the plain forward uses the
    # row max, so the saved o (and dsum from it) differ by bf16 noise; each
    # fp32 gradient lies within twice bf16's own noise of the plain one,
    # e = |plain bf16 - plain fp32| (relative Frobenius), or within the K2b
    # bound where it has none (dbproj sums the bf16 cotangent alone).
    want = TA.rung3_block_bwd_reference(*args, H, dout, "K8")
    want32 = TA.rung3_block_bwd_reference(args[0].float(), *args[1:], H, dout.float(), "K8")
    torch.testing.assert_close(grads[0].float(), want[0].float(), **BF16_TOL)
    for i, (g, w, w32) in enumerate(zip(grads[1:], want[1:], want32[1:]), start=1):
        noise = float(torch.linalg.norm(w - w32) / torch.linalg.norm(w32))
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= max(
            2 * noise, GRAD_FROB_REL), i


@pytest.mark.cuda
def test_k8_refuses_what_it_does_not_take(cuda_device):
    """Head widths the JAX gate never admits raise ``NotImplementedError``;
    token counts off the 64-row tiles and other types raise."""
    x = torch.zeros(1, 1024, 144, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head widths the JAX gate admits"):
        TF.flash_attention(x, x, x, 6)  # Dh = 24
    with pytest.raises(NotImplementedError, match="head widths the JAX gate admits"):
        TF.flash_attention(x[..., :2], x[..., :2], x[..., :2], 1)  # Dh = 2
    y = torch.zeros(1, 1000, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        TF.flash_attention(y, y, y, 2)
    with pytest.raises(TypeError, match="bf16"):
        TF.flash_attention(y.float(), y.float(), y.float(), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(2, 1024, 12, 32), (2, 1024, 3, 128), (1, 2048, 2, 128),
                                      (3, 128, 4, 32)])
def test_k8_at_head_widths_32_and_128_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K8f and K8b at Dh = 32 and 128 (the templated kernels), q, k, v read
    in place from a [q | k | v] buffer, against the plain versions; the
    backward twice, bit-identical."""
    r = np.random.default_rng(Dh + N)
    D = H * Dh
    qkv = _t(r.standard_normal((B, N, 3 * D)).astype(np.float32)).to(cuda_device)
    q, k, v = qkv.to(torch.bfloat16).split(D, dim=-1)
    do = _t(r.standard_normal((B, N, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    o, lse = TF.flash_attention_fwd(q, k, v, H)
    grads = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    again = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    for g, h, w in zip(grads, again, TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Dh", [(32, 4), (3, 4), (16, 8), (8, 16), (3, 16), (3, 256), (2, 384),
                                  (2, 512), (1, 640), (1, 768), (1, 896)])
def test_k8_at_every_head_width_the_jax_gate_admits(cuda_device, H, Dh):
    """K8f and K8b at the narrow widths (Dh 4, 8, 16 on 16-column tiles; an
    odd head count puts a Dh-4 head on an 8-byte boundary) and the wide
    ones (256-896, walked in 128-column chunks), B 2 and N 1024, q, k, v
    read in place from a [q | k | v] buffer, against the plain versions;
    the backward twice, bit-identical."""
    B, N, D = 2, 1024, H * Dh
    gen = torch.Generator(device=cuda_device).manual_seed(Dh + H)
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    assert TF.flash_supported(N, Dh)
    before = (TF.FWD_LAUNCHES.count, TF.BWD_LAUNCHES.count)
    o, lse = TF.flash_attention_fwd(q, k, v, H)
    grads = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    again = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    assert (TF.FWD_LAUNCHES.count, TF.BWD_LAUNCHES.count) == (before[0] + 1, before[1] + 2)
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    for g, h, w in zip(grads, again, TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(256, 256, 16, 64), (64, 256, 16, 64), (32, 64, 16, 64),
                                      (4, 112, 4, 32), (2, 48, 2, 128), (64, 256, 16, 72),
                                      (32, 64, 16, 72), (8, 256, 16, 24), (4, 112, 4, 40),
                                      (8, 64, 16, 8)])
def test_k7_kernels_match_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K7f and K7b on q, k, v read in place from a [q | k | v] buffer (and
    on three separate tensors), against their plain versions by the bf16
    rule; K7b twice, bit-identical; and bit for bit the cores that K2f and
    K2b run on the same qkv (one design behind two entry points): K7f the
    forward core's plan pick, K7b's dq, dk and dv the backward core's, whose
    att is the resident forward core's."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    before = (TA.CORE_LAUNCHES.count, TA.CORE_BWD_LAUNCHES.count)
    o = TA.attention_core_fwd(q, k, v, H)
    grads = TA.attention_core_bwd(q, k, v, do, H)
    again = TA.attention_core_bwd(q, k, v, do, H)
    apart = TA.attention_core_fwd(*(t.contiguous() for t in (q, k, v)), H)
    torch.cuda.synchronize()
    assert (TA.CORE_LAUNCHES.count, TA.CORE_BWD_LAUNCHES.count) == (before[0] + 2, before[1] + 2)
    assert torch.equal(apart, o)
    _assert_bf16_rule(o, TA.attention_reference(q, k, v, H))
    for g, h, w in zip(grads, again, TA.attention_core_bwd_reference(q, k, v, do, H)):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)
    assert torch.equal(o, TA._k2_core(qkv, H))
    att, dqkv = TA._core_bwd_att(qkv, do, H)
    assert torch.equal(torch.cat(grads, dim=-1), dqkv)
    earlier = TA._core_bwd_att(qkv, do, H, _earlier_bwd(N, Dh))[0]
    assert torch.equal(earlier, TA._k2_core(qkv, H, "resident"))
    _assert_bf16_rule(o, att)
    _assert_bf16_rule(att, earlier)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,core", [(8, 256, 1024, 16, "K7"), (2, 576, 384, 6, None),
                                          (2, 1024, 384, 3, "K8"), (8, 256, 1152, 16, "K7"),
                                          (2, 1024, 384, 24, "K8"), (2, 1024, 768, 3, "K8"),
                                          (8, 64, 1472, 8, None), (8, 64, 480, 6, None),
                                          (8, 64, 1536, 16, "K7")])
def test_rung3_half_block_matches_plain_on_the_card(cuda_device, B, N, D, H, core):
    """The JAX ladder's third rung on the card: DiT-L at N = 256 around
    K7f/K7b, N = 576 around the plain core (JAX runs XLA's attention),
    Dh = 128, 16 and 256 at N = 1024 around K8, and at D 1472 and 480 (no
    GEMM tier: plain products around the plain core, as JAX's XLA) and D
    1536 (plain products around K7); forward by the bf16 rule, all seven
    gradients through autograd twice (bit-identical) against the plain
    rung-3 backward, within twice bf16's own noise where K8's online
    softmax rounds p against a running max."""
    assert TT.attention_tier(B, N, D, H) is None and TT.core_tier(B, N, D, H) == core
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=23))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(24),
                       device=cuda_device).to(torch.bfloat16)
    counters = (TA.LAUNCHES, TA.BWD_LAUNCHES, TA.SPLIT_BWD_LAUNCHES, TA.CORE_LAUNCHES,
                TA.CORE_BWD_LAUNCHES, TF.FWD_LAUNCHES, TF.BWD_LAUNCHES)
    before = [c.count for c in counters]
    with torch.inference_mode():
        out = TA.fused_attention_block(*args, H)
    want = TA.rung3_block_reference(*args, H, core)
    got = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    again = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    torch.cuda.synchronize()
    k7, k8 = (3, 2) if core == "K7" else (0, 0), (3, 2) if core == "K8" else (0, 0)
    assert [c.count - n for c, n in zip(counters, before)] == [0, 0, 0, *k7, *k8]
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    wgrads = TA.rung3_block_bwd_reference(*args, H, dout, core)
    if core == "K8":
        torch.testing.assert_close(out.float(), want.float(), **BF16_TOL)
        want32 = TA.rung3_block_bwd_reference(args[0].float(), *args[1:], H, dout.float(), core)
        torch.testing.assert_close(got[0].float(), wgrads[0].float(), **BF16_TOL)
        for i, (g, w, w32) in enumerate(zip(got[1:], wgrads[1:], want32[1:]), start=1):
            noise = float(torch.linalg.norm(w - w32) / torch.linalg.norm(w32))
            assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= max(
                2 * noise, GRAD_FROB_REL), i
    else:
        _assert_bf16_rule(out, want)
        _assert_grads_close(got, wgrads)


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,D,F", [(8, 20480, 384, 1536), (4, 200, 128, 256)])
def test_k10_kernels_match_plain_on_the_card(cuda_device, E, S, D, F):
    """The expert FFN forward and its five gradients through autograd, twice
    (bit-identical), on slot rows whose tail is empty as the dispatch leaves it."""
    r = np.random.default_rng(9)
    x = r.standard_normal((E, S, D)).astype(np.float32)
    x[:, S - S // 5:] = 0.0
    args = [_t(x).to(cuda_device).to(torch.bfloat16)] + [_t(a).to(cuda_device) for a in (
        (D ** -0.5 * r.standard_normal((E, D, F))).astype(np.float32),
        (0.1 * r.standard_normal((E, F))).astype(np.float32),
        (F ** -0.5 * r.standard_normal((E, F, D))).astype(np.float32),
        (0.1 * r.standard_normal((E, D))).astype(np.float32))]
    dout = _t(r.standard_normal((E, S, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    before = (TX.LAUNCHES.count, TX.BWD_LAUNCHES.count)
    with torch.inference_mode():
        out = TX.expert_ffn(*args)
    _assert_bf16_rule(out, TX.expert_ffn_reference(*args))
    got = _grads_through_autograd(TX.expert_ffn, args, (), dout)
    again = _grads_through_autograd(TX.expert_ffn, args, (), dout)
    torch.cuda.synchronize()
    assert (TX.LAUNCHES.count, TX.BWD_LAUNCHES.count) == (before[0] + 3, before[1] + 2)
    _assert_grads_close(got, TX.expert_ffn_bwd_reference(*args, dout))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def _moe_inputs(device, T, D, E, seed=10):
    r = np.random.default_rng(seed)
    a = [r.standard_normal((T, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
         D ** -0.5 * r.standard_normal((D, E)), 0.1 * r.standard_normal(E)]
    x, *rest = (_t(v.astype(np.float32)).to(device) for v in a)
    return (x.to(torch.bfloat16), *rest)


def _softmax_close(got, want, tol):
    """Router probabilities or gates against the plain version's, where
    every logit may move by up to ``tol``: a softmax output p (and a top-2
    gate, a softmax of two logits) then moves by at most p (e^(2 tol) - 1),
    plus four fp32 units of p for its own roundings. Relative, so that a
    wrong probability fails at any E, however small 1 / E is."""
    want = want.float()
    f32 = torch.finfo(torch.float32)
    bound = want * (math.expm1(2 * tol) + 4 * f32.eps) + f32.tiny
    assert bool(((got.float() - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("T,D,E,gs,n_valid", [(131072, 384, 8, 256, 131072),
                                              (512, 128, 4, 64, 450),
                                              (32768, 1152, 8, 256, 32768),
                                              (32768, 1152, 16, 256, 32700),
                                              (16384, 2048, 8, 256, 16384),
                                              (8192, 384, 64, 256, 8192),
                                              (131072, 384, 128, 256, 131072),
                                              (32768, 384, 256, 256, 32768),
                                              (32768, 384, 512, 256, 32700),
                                              (32768, 4224, 8, 256, 32768),
                                              (32768, 6144, 8, 256, 32768),
                                              (32768, 8192, 8, 256, 32768),
                                              (2048, 11520, 8, 2048, 2048)])
def test_k11_k12_kernels_match_plain_on_the_card(cuda_device, topk, T, D, E, gs, n_valid):
    """Dispatch and combine, forward and backward, against their plain
    versions; the second case pads 62 rows that take no route, the next ones
    are DiT-XL/4's width with 8 and 16 experts (68 padded rows), D 2048 (the
    backward's column tiles), 64 experts (two a lane), DiT-S/4's 128 routed
    experts at its training shape, 256 and 512 experts (the backward's tile
    narrowed to fit E), D 4224, 6144 and 8192 past the earlier bound of
    4096 (Mixtral-8x22B's width among them), and D 11,520 in one group of
    2048 rows (the most a group takes, its per-row state filling 48 KB of
    shared memory). The kernel's
    LN statistics differ from the plain version's in the last fp32 bits,
    which can flip the bf16 rounding of an LN output entry and so move a
    logit by one bf16 unit of the largest |yb| times max |wr|: a token may
    route otherwise only within twice that of a tie, the gates and router
    probabilities agree to it as softmax outputs do (:func:`_softmax_close`),
    and groups whose routing differs are left out of the slot-row comparison."""
    cfg, _ = TD.moe_cfg(T, E, gs, 1.25, topk)
    G = T // gs
    x, scale, bias, wr, br = _moe_inputs(cuda_device, T, D, E)
    before = {n: c.count for n, c in (("f", TD.DISPATCH_LAUNCHES), ("b", TD.DISPATCH_BWD_LAUNCHES),
                                      ("cf", TD.COMBINE_LAUNCHES), ("cb", TD.COMBINE_BWD_LAUNCHES))}
    got = TD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br, n_valid)
    want = TD.moe_dispatch_reference(cfg, x, scale, bias, wr, br, n_valid)
    xin, gates, pos1, pos2, probs, cnt, psum = got
    experts = [torch.stack([TD.chosen(p)[0].reshape(-1) for p in o[2:4]]) for o in (got, want)]
    moved = (experts[0] != experts[1]).any(0)
    y = TM.layer_norm(x.float(), scale, bias).to(torch.bfloat16).float()
    tol = 2.0 * 2.0 ** (np.floor(np.log2(float(y.abs().max()))) - 7) * float(wr.abs().max())
    if moved.any():  # near ties only
        top = (y[moved] @ wr + br).topk(topk + 1, dim=-1).values
        assert float((top[:, :-1] - top[:, 1:]).min(-1).values.max()) < tol
    agree = ((pos1 == want[2]) & (pos2 == want[3])).flatten(1).all(1)
    assert int(agree.sum()) >= G - int(moved.sum())
    slots = lambda t: t.view(E, G, cfg.cpad, D)[:, agree]  # noqa: E731
    _assert_bf16_rule(slots(xin), slots(want[0]))
    assert not slots(xin)[~slots(want[0]).any(-1)].any()  # unheld slot rows are zeros
    _softmax_close(gates[agree], want[1][agree], tol)
    _softmax_close(probs, want[4], tol)
    assert float((cnt - want[5]).abs().max()) <= int(moved.sum())
    torch.testing.assert_close(psum, want[6], rtol=1e-5, atol=0)
    assert not gates.view(-1, 2)[n_valid:].any() and (pos1.view(-1, E)[n_valid:] < 0).all()

    gen = torch.Generator(device=cuda_device).manual_seed(11)
    dxin = torch.randn(xin.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    dgates = torch.randn(gates.shape, generator=gen, device=cuda_device)
    dpsum = torch.randn((E,), generator=gen, device=cuda_device)
    dres = torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    routing = (pos1, pos2, probs)
    for res in (dres, None):
        g1 = TD.moe_dispatch_bwd(cfg, x, scale, bias, wr, *routing, dxin, dgates, dpsum, res,
                                 n_valid)
        g2 = TD.moe_dispatch_bwd(cfg, x, scale, bias, wr, *routing, dxin, dgates, dpsum, res,
                                 n_valid)
        for g, h in zip(g1, g2):
            assert torch.equal(g, h)
        _assert_grads_close(g1, TD.moe_dispatch_bwd_reference(
            cfg, x, scale, bias, wr, *routing, dxin, dgates, dpsum, res, n_valid))

    eout = torch.randn(xin.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    dpart = torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    for res in (x, None):
        _assert_bf16_rule(TD.moe_combine_fwd(cfg, eout, gates, pos1, pos2, res),
                          TD.moe_combine_reference(cfg, eout, gates, pos1, pos2, res))
    (dout, dg), again = (TD.moe_combine_bwd(cfg, eout, gates, pos1, pos2, dpart) for _ in range(2))
    assert torch.equal(dout, again[0]) and torch.equal(dg, again[1])
    want_dout, want_dg = TD.moe_combine_bwd_reference(cfg, eout, gates, pos1, pos2, dpart)
    _assert_bf16_rule(dout, want_dout)
    assert not dout[~want_dout.any(-1)].any()
    assert float((dg - want_dg).abs().max()) <= 1e-4 * float(want_dg.abs().max())
    torch.cuda.synchronize()
    after = {n: c.count for n, c in (("f", TD.DISPATCH_LAUNCHES), ("b", TD.DISPATCH_BWD_LAUNCHES),
                                     ("cf", TD.COMBINE_LAUNCHES), ("cb", TD.COMBINE_BWD_LAUNCHES))}
    assert {n: after[n] - before[n] for n in after} == {"f": 1, "b": 4, "cf": 2, "cb": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,E,topk,gs,slab", [(8192, 4096, 8, 2, 256, 1024),
                                                 (8192, 384, 128, 1, 256, 128),
                                                 (4096, 2048, 64, 2, 256, 640),
                                                 (2048, 11520, 8, 2, 2048, 1280)])
def test_k11b_column_slabs_keep_the_bits(cuda_device, monkeypatch, T, D, E, topk, gs, slab):
    """K11b with its per-group partials reduced in column slabs (a scratch
    bound lowered until ``_bwd_slab`` gives ``slab``; 640 leaves a short last
    slab at D 2048, 1280 nine slabs of one 2048-row group at D 11,520):
    bit-identical to the one-slab launch."""
    cfg, _ = TD.moe_cfg(T, E, gs, 1.25, topk)
    G = T // gs
    x, scale, bias, wr, br = _moe_inputs(cuda_device, T, D, E)
    xin, gates, pos1, pos2, probs = TD._k11f(cfg, x, scale, bias, wr, br, T)[:5]
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    dxin = torch.randn(xin.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    dgates = torch.randn(gates.shape, generator=gen, device=cuda_device)
    dpsum = torch.randn((E,), generator=gen, device=cuda_device)
    dres = torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    args = (cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum, dres, T)
    assert TD._bwd_slab(G, D, E) == D  # these shapes take one slab by default
    one = TD._k11b(*args)
    monkeypatch.setattr(TD, "MOE_BWD_SCRATCH_BYTES", G * E * 4 + slab * G * (2 + E) * 4)
    assert TD._bwd_slab(G, D, E) == slab
    for a, b in zip(one, TD._k11b(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_moe_kernels_refuse_what_they_do_not_take(cuda_device):
    x, scale, bias, wr, br = _moe_inputs(cuda_device, 200, 128, 4)
    cfg, _ = TD.moe_cfg(200, 4, 100, 1.25, 1)  # gs = 100 is not a multiple of 8
    # where the JAX gate takes no kernel (its einsum path), the plain version
    before = TD.DISPATCH_LAUNCHES.count
    got = TD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br)
    assert TD.DISPATCH_LAUNCHES.count == before
    for g, w in zip(got, TD.moe_dispatch_reference(cfg, x, scale, bias, wr, br)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="moe_dispatch_ok"):
        TD._check_dispatch(cfg, x, scale, bias, wr, br)
    cfg, _ = TD.moe_cfg(200, 4, 40, 1.25, 1)
    with pytest.raises(TypeError, match="bf16"):
        TD.moe_dispatch_fwd(cfg, x.float(), scale, bias, wr, br)
    # every E the JAX gate takes launches (72: a lane holds three experts) ...
    x, scale, bias, wr, br = _moe_inputs(cuda_device, 256, 128, 72)
    cfg, _ = TD.moe_cfg(256, 72, 256, 1.25, 1)
    before = TD.DISPATCH_LAUNCHES.count
    TD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br)
    assert TD.DISPATCH_LAUNCHES.count == before + 1
    # ... as far as a block's per-expert state fits the card's shared
    # memory: past it the launcher raises before any launch, and never
    # falls back to the plain version
    x, scale, bias, wr, br = _moe_inputs(cuda_device, 2048, 128, 8192)
    cfg, _ = TD.moe_cfg(2048, 8192, 2048, 1.25, 1)
    with pytest.raises(RuntimeError, match="moe_dispatch_fwd at gs=2048, D=128, E=8192"):
        TD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br)
    assert TD.DISPATCH_LAUNCHES.count == before + 1
    w1 = torch.zeros(4, 128, 256, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        TX.expert_ffn(torch.zeros(4, 16, 128, device=cuda_device), w1,
                      torch.zeros(4, 256, device=cuda_device), w1.transpose(1, 2),
                      torch.zeros(4, 128, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,forced", [(2048, 64, 1024, 16, False),
                                            (256, 64, 768, 12, False), (3, 16, 128, 2, True),
                                            (256, 64, 1152, 16, False)])
def test_k4_split_backward_matches_plain_on_the_card(cuda_device, monkeypatch, B, N, D, H,
                                                     forced):
    """K4 where the JAX ladder takes it (DiT-L and DiT-B widths) and, forced,
    at a small shape: all seven gradients through autograd, twice
    (bit-identical), against the plain backward that K2b shares."""
    if forced:
        monkeypatch.setattr(TT, "attention_tier", lambda *a: "split")
    assert TT.attention_tier(B, N, D, H) == "split"
    args = _on(cuda_device, _attn_inputs(B, N, D))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(12),
                       device=cuda_device).to(torch.bfloat16)
    before = (TA.SPLIT_BWD_LAUNCHES.count, TA.BWD_LAUNCHES.count)
    got = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    again = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    torch.cuda.synchronize()
    assert (TA.SPLIT_BWD_LAUNCHES.count - before[0], TA.BWD_LAUNCHES.count - before[1]) == (2, 0)
    _assert_grads_close(got, TA.attention_block_bwd_reference(*args, H, dout))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F,forced", [(131072, 1024, 4096, False), (1000, 128, 512, True),
                                         (16384, 1152, 4608, False)])
def test_k6f_fchunked_mlp_matches_plain_on_the_card(cuda_device, monkeypatch, T, D, F, forced):
    """One K6f partial on the second hidden chunk, read in place from the
    bf16 weights (fp32, by the partial rule: single flipped bf16 roundings
    of LN outputs or hidden entries move single entries by up to ~1e-3 of
    the largest, the bulk agrees to fp32 sums); the
    F-chunked half-block at k = 2 by the bf16 rule; its backward (K1b's
    chain) through autograd, twice, bit-identical."""
    if forced:
        monkeypatch.setattr(TT, "mlp_tier", lambda *a: ("fchunked", 2))
    assert TT.mlp_tier(T, D, F) == ("fchunked", 2)
    args = _on(cuda_device, _mlp_inputs(T, D, F, seed=13))
    x, scale, bias, w1, b1, w2, b2 = args
    fc = F // 2
    part = (x, scale, bias, w1.to(torch.bfloat16)[fc:], b1[fc:], w2.to(torch.bfloat16)[:, fc:])
    p = torch.empty(T, D, device=cuda_device)
    before = (TM.PARTIAL_LAUNCHES.count, TM.LAUNCHES.count)
    with torch.inference_mode():
        TM._k6f(*part, TM.gemm.PART_STORE, p)
        out = TM.fused_mlp_block(*args)
    torch.cuda.synchronize()
    assert (TM.PARTIAL_LAUNCHES.count - before[0], TM.LAUNCHES.count - before[1]) == (3, 0)
    _assert_partial_rule(p, TM.mlp_partial_reference, part, lambda a, pd, pf: (
        a[0][:, pd].contiguous(), a[1][pd], a[2][pd], a[3][pf][:, pd], a[4][pf], a[5][pd][:, pf]))
    _assert_bf16_rule(out, TM.mlp_block_fchunked_reference(*args, 2))
    dout = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(14),
                       device=cuda_device).to(torch.bfloat16)
    bwd_before = TM.BWD_LAUNCHES.count
    got = _grads_through_autograd(TM.fused_mlp_block, args, (), dout)
    again = _grads_through_autograd(TM.fused_mlp_block, args, (), dout)
    torch.cuda.synchronize()
    assert TM.BWD_LAUNCHES.count == bwd_before + 2
    _assert_grads_close(got, TM.mlp_block_bwd_reference(*args, dout))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def _k6f_chunk(args, c, k):
    """Chunk c of k of the MLP weights as ``_k6f`` reads them: the bf16 W1 row
    chunk and the W2 column chunk, a view of the whole bf16 weight."""
    x, scale, bias, w1, b1, w2, _ = args
    fc = w1.shape[0] // k
    hid = slice(c * fc, (c + 1) * fc)
    return (x, scale, bias, w1.to(torch.bfloat16)[hid], b1[hid], w2.to(torch.bfloat16)[:, hid])


def _k6f_permuted(a, pd, pf):
    return (a[0][:, pd].contiguous(), a[1][pd], a[2][pd], a[3][pf][:, pd], a[4][pf],
            a[5][pd][:, pf])


def _assert_k6f_stages(p, part, fast):
    """K6f's chunk held stage by stage to fp64 references, each within a
    bound derived from its depth (``chip_smoke._k6f_stages``: y, the bf16 LN
    output; g, the bf16 GELU output; the fp32 partial p), so the LN
    statistics' order and the tensor cores' accumulation order both fall
    inside it."""
    import chip_smoke

    y_used, _, g_used, p_used = chip_smoke._k6f_stages(TM, TM.gemm, part, p, fast)
    assert y_used <= 1 and g_used <= 1 and p_used <= 1, (y_used, g_used, p_used)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("T,D,F,k,whole", [(131072, 1024, 4096, 2, True),
                                           (131072, 1152, 4608, 2, True),
                                           (131072, 1536, 6144, 8, True),
                                           (16384, 1536, 6144, 8, False),
                                           (4040, 4096, 4096, 8, False)])
def test_k6f_wgmma_chunks_match_plain_on_the_card(cuda_device, monkeypatch, T, D, F, k, whole,
                                                   fast):
    """K6f on the wgmma ring (``ln_gemm_wg`` + ``gemm_partial_wg``) at the
    widths the ladder tiers ``fchunked``: DiT-L, DiT-XL, D 1536 at k 8 (the
    trainer's rows and the sampler's 16,384) and D 4096 at k 8 (a smaller
    T, ragged against 128): every chunk's fp32 partial (store epilogue)
    stage by stage (:func:`_assert_k6f_stages`), the k-chunk half-block
    (store, add, final) against the plain version by the bf16 rule, with no
    WMMA product. Where ``whole`` the partial is also held to the plain
    version from x by the partial rule. That rule fails for both designs at
    D 1536 on the sampler's rows (relF 1.121e-4 against 1.095e-4) and at D
    3072-4096 (1.6-1.8e-4 against 1.2e-4): the tensor cores' fp32
    accumulation in the two products errs more than the plain version's
    reordered IEEE spread models, growing with D (the LN output y stays
    within half a bf16 unit of the fp32 LN). There each chunk is also held
    bit for bit to the earlier WMMA design's partial, which the paths ran at
    those widths before."""
    assert TT.mlp_tier(T, D, F) == ("fchunked", k)
    args = _on(cuda_device, _mlp_inputs(T, D, F, seed=80))
    wmma_ln, wmma_partial = TM.gemm.ln_gemm, TM.gemm.gemm_partial
    for name in WMMA_LAUNCHERS:
        monkeypatch.setattr(TM.gemm, name, _refuse_wmma)
    before = TM.PARTIAL_LAUNCHES.count
    with torch.inference_mode():
        for c in range(k):
            part = _k6f_chunk(args, c, k)
            p = torch.empty(T, D, device=cuda_device)
            TM._k6f(*part, TM.gemm.PART_STORE, p, fast_gelu=fast)
            torch.cuda.synchronize()
            _assert_k6f_stages(p, part, fast)
            if whole:
                _assert_partial_rule(p, lambda *a: TM.mlp_partial_reference(*a, fast_gelu=fast),
                                     part, _k6f_permuted)
            else:
                hidden, _, _ = wmma_ln(*part[:5], TM.gemm.EPI_GELU, fast_gelu=fast)
                q = torch.empty_like(p)
                wmma_partial(hidden, part[5], TM.gemm.PART_STORE, q)
                torch.cuda.synchronize()
                assert torch.equal(p, q), c
                del hidden, q
            del p
        out = TM.fused_mlp_block(*args, fast_gelu=fast)
        torch.cuda.synchronize()
        _assert_bf16_rule(out, TM.mlp_block_fchunked_reference(*args, k, fast_gelu=fast))
    assert TM.PARTIAL_LAUNCHES.count == before + 2 * k


def _expert_inputs(E, S, D, F, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((E, S, D)).astype(np.float32)
    x[:, S - S // 5:] = 0.0  # the dispatch leaves the tail of the slot rows empty
    return [_t(x).to(torch.bfloat16)] + [_t(a) for a in (
        (D ** -0.5 * r.standard_normal((E, D, F))).astype(np.float32),
        (0.1 * r.standard_normal((E, F))).astype(np.float32),
        (F ** -0.5 * r.standard_normal((E, F, D))).astype(np.float32),
        (0.1 * r.standard_normal((E, D))).astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("E,S,D,F", [(8, 20480, 384, 1536), (2, 192, 384, 1536),
                                     (8, 1344, 768, 3072), (16, 64, 128, 512)])
def test_k10b_wgmma_chain_matches_plain_on_the_card(cuda_device, monkeypatch, E, S, D, F, fast):
    """K10b's five products on the expert coordinate (the MoE shape, and S
    ragged against the 128-row tile: 192, 1344, 64), erf and sigmoid GELU,
    against the plain backward by the gradient rules; a second call is
    bit-identical; no transposed weight copy, no WMMA product."""
    args = [a.to(cuda_device) for a in _expert_inputs(E, S, D, F, seed=81)]
    for name in WMMA_LAUNCHERS:
        monkeypatch.setattr(TX.gemm, name, _refuse_wmma)
    dout = torch.randn(E, S, D, generator=torch.Generator(device=cuda_device).manual_seed(82),
                       device=cuda_device).to(torch.bfloat16)
    before = TX.BWD_LAUNCHES.count
    with torch.no_grad():
        got = TX.expert_ffn_bwd(*args, dout, fast_gelu=fast)
        again = TX.expert_ffn_bwd(*args, dout, fast_gelu=fast)
        torch.cuda.synchronize()
    assert TX.BWD_LAUNCHES.count == before + 2
    _assert_grads_close(got, TX.expert_ffn_bwd_reference(*args, dout, fast_gelu=fast))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,D,F", [(8, 1344, 384, 1536), (3, 192, 256, 1024)])
def test_expert_coordinate_gives_each_experts_dense_bits_on_the_card(cuda_device, monkeypatch,
                                                                      E, S, D, F):
    """Expert e's dW1 and dx from the batched products equal, bit for bit,
    the wgmma products on that expert's slice alone: dW1 from its 2-D
    operands with the batched split plan, dx through the product at E 1; and
    the batched products are those ``_k10b`` returns."""
    G = TX.gemm
    x, w1, b1, w2, b2 = [a.to(cuda_device) for a in _expert_inputs(E, S, D, F, seed=83)]
    dout = torch.randn(E, S, D, generator=torch.Generator(device=cuda_device).manual_seed(84),
                       device=cuda_device).to(torch.bfloat16)
    w1b, w2b = w1.to(torch.bfloat16), w2.to(torch.bfloat16).contiguous()
    with torch.no_grad():
        _, dfac = G.expert_nn_wg(x, w1b, G.NN_BIAS_GELU_GRAD, bias=b1)
        dhb, _ = G.expert_nn_wg(dout, w2b, G.NN_DGELU, dfac=dfac, transposed=True)
        dw1, _ = G.expert_tn_wg(x, dhb)
        dx = G.expert_nn_wg(dhb, w1b, G.NN_BF16, transposed=True)
        chain = TX._k10b(x, w1, b1, w2, b2, dout)
        plan = G.wg_split_plan(S, D, F, G.sm_count(0), batch=E)
        monkeypatch.setattr(G, "wg_split_plan", lambda *a, **kw: plan)
        for e in range(E):
            dense_dw1, _ = G.expert_tn_wg(x[e], dhb[e])
            dense_dx = G.expert_nn_wg(dhb[e:e + 1], w1b[e:e + 1], G.NN_BF16, transposed=True)
            torch.cuda.synchronize()
            assert torch.equal(dense_dw1, dw1[e]) and torch.equal(dense_dx[0], dx[e]), e
    assert torch.equal(chain[0], dx) and torch.equal(chain[1], dw1)


def _at_one_expert(fn):
    """``fn`` (``expert_nn_wg`` or ``expert_tn_wg``) with a dense product's
    2-D operands passed as one expert, (1, T, *), explicitly."""
    def run(a, b, *args, **kwargs):
        if a.dim() == 3:
            return fn(a, b, *args, **kwargs)
        if kwargs.get("dfac") is not None:
            kwargs["dfac"] = kwargs["dfac"][None]
        got = fn(a[None], b[None], *args, **kwargs)
        if isinstance(got, tuple):
            return tuple(None if t is None else t[0] for t in got)
        return got[0]
    return run


@pytest.mark.cuda
def test_dense_chains_keep_their_bits_at_one_expert_on_the_card(cuda_device, monkeypatch):
    """K1b and K2b (DiT-S/4's training rows, ragged T too) are bit-identical
    between two calls, and equal to the same chains with their NN and TN
    products' 2-D operands passed to the expert launchers as (1, T, *)."""
    mlp = _on(cuda_device, _mlp_inputs(16384 + 37, 384, 1536, seed=85))
    attn = _on(cuda_device, _attn_inputs(256, 64, 384, seed=86))
    gen = torch.Generator(device=cuda_device).manual_seed(87)
    dm = torch.randn(mlp[0].shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    da = torch.randn(attn[0].shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    def run():
        with torch.no_grad():
            return TM.mlp_block_bwd(*mlp, dm), TA.attention_block_bwd(*attn, 6, da)

    first, second = run(), run()
    for name in ("expert_nn_wg", "expert_tn_wg"):
        monkeypatch.setattr(TM.gemm, name, _at_one_expert(getattr(TM.gemm, name)))
    explicit = run()
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, explicit):
        for g, h, i in zip(a, b, c):
            assert torch.equal(g, h) and torch.equal(g, i)


def _assert_k10p_stages(p, chunk, fast):
    """K10p's chunk held stage by stage to fp64 references, each within a
    bound derived from its depth (``chip_smoke._k10p_stages``: g, the first
    product's bf16 GELU output; the fp32 partial p), so the tensor cores'
    accumulation order falls inside it."""
    import chip_smoke

    g_used, p_used = chip_smoke._k10p_stages(TX, TX.gemm, chunk, p, fast)
    assert g_used <= 1 and p_used <= 1, (g_used, p_used)


def _k10p_permuted(a, pd, pf):
    return a[0][:, :, pd].contiguous(), a[1][:, pd][:, :, pf], a[2][:, pf], a[3][:, pf][:, :, pd]


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,D,F,k,forced,fast,whole", [
    (8, 20480, 768, 3072, 2, False, False, True), (4, 200, 128, 512, 2, True, False, True),
    (8, 20480, 1152, 4608, 4, False, False, True), (8, 1344, 3072, 3072, 8, False, False, False),
    (8, 20480, 768, 3072, 2, False, True, True)])
def test_k10p_matches_plain_on_the_card(cuda_device, monkeypatch, E, S, D, F, k, forced, fast,
                                        whole):
    """The expert FFN's F-chunked forward (k K10p on the wgmma ring's expert
    coordinate) by the bf16 rule: DiT-B's MoE chunks, a forced ragged case,
    the XL MoE (k 4), the widest chunked width (D 3072 at k 8, S ragged
    against 128) and the fast GELU; every chunk's fp32 partial stage by
    stage (:func:`_assert_k10p_stages`) and, where ``whole``, from x by the
    partial rule, which at D 3072 the tensor cores' fp32 accumulation does
    not meet (as K6f's at D 3072-4096); and the five gradients of K10b's
    chain through autograd, twice, bit-identical."""
    if forced:
        monkeypatch.setattr(TT, "expert_tier", lambda *a: ("fwdonly", k))
    assert TT.expert_tier(E, S, D, F) == ("fwdonly", k)
    r = np.random.default_rng(15)
    x = r.standard_normal((E, S, D)).astype(np.float32)
    x[:, S - S // 5:] = 0.0
    args = [_t(x).to(cuda_device).to(torch.bfloat16)] + [_t(a).to(cuda_device) for a in (
        (D ** -0.5 * r.standard_normal((E, D, F))).astype(np.float32),
        (0.1 * r.standard_normal((E, F))).astype(np.float32),
        (F ** -0.5 * r.standard_normal((E, F, D))).astype(np.float32),
        (0.1 * r.standard_normal((E, D))).astype(np.float32))]
    dout = _t(r.standard_normal((E, S, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    before = (TX.PARTIAL_LAUNCHES.count, TX.LAUNCHES.count, TX.BWD_LAUNCHES.count)
    with torch.inference_mode():
        out = TX.expert_ffn(*args, fast_gelu=fast)
    _assert_bf16_rule(out, TX.expert_ffn_fchunked_reference(*args, k, fast_gelu=fast))
    del out
    fc, bf = F // k, torch.bfloat16
    w1b, w2b = args[1].to(bf), args[3].to(bf)
    for c in range(k):
        hid = slice(c * fc, (c + 1) * fc)
        chunk = (args[0], w1b[:, :, hid], args[2][:, hid], w2b[:, hid])
        acc = torch.empty(E, S, D, device=cuda_device)
        with torch.inference_mode():
            TX._k10p(*chunk, TX.gemm.NN_F32, acc, fast_gelu=fast)
        torch.cuda.synchronize()
        _assert_k10p_stages(acc, chunk, fast)
        if whole:
            _assert_partial_rule(acc, lambda *a: TX.expert_partial_reference(*a, fast_gelu=fast),
                                 chunk, _k10p_permuted)
        del acc
    fn = lambda *a: TX.expert_ffn(*a, fast_gelu=fast)  # noqa: E731
    got = _grads_through_autograd(fn, args, (), dout)
    again = _grads_through_autograd(fn, args, (), dout)
    torch.cuda.synchronize()
    after = (TX.PARTIAL_LAUNCHES.count, TX.LAUNCHES.count, TX.BWD_LAUNCHES.count)
    assert tuple(a - b for a, b in zip(after, before)) == (k + k + 2 * k, 0, 2)
    _assert_grads_close(got, TX.expert_ffn_bwd_reference(*args, dout, fast_gelu=fast))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_wide_tiers_refuse_what_they_do_not_take(cuda_device):
    """Shapes where the JAX ladder has no kernel tier (D = 64): the MLP
    half-block and the expert FFN run their plain versions on the device, as
    the JAX package runs its jnp reference there, forward and backward, with
    no launch; the attention half-block takes the third rung around the
    plain core (JAX's XLA attention at D % 128 != 0), no K2, K7 or K8."""
    bf = torch.bfloat16
    r = np.random.default_rng(18)
    z = lambda *s, dt=torch.float32: _t(  # noqa: E731
        r.standard_normal(s).astype(np.float32)).to(cuda_device).to(dt)
    counters = (TM.LAUNCHES, TM.BWD_LAUNCHES, TM.PARTIAL_LAUNCHES, TX.LAUNCHES,
                TX.BWD_LAUNCHES, TX.PARTIAL_LAUNCHES)
    before = [c.count for c in counters]
    mlp = (z(128, 64, dt=bf), z(64), z(64), z(256, 64), z(256), z(64, 256), z(64))
    dout = z(128, 64, dt=bf)
    assert torch.equal(TM.fused_mlp_block(*mlp), TM.mlp_block_reference(*mlp))
    for g, w in zip(_grads_through_autograd(TM.fused_mlp_block, mlp, (), dout),
                    TM.mlp_block_bwd_reference(*mlp, dout)):
        assert torch.equal(g, w.to(g.dtype))
    ffn = (z(4, 64, 64, dt=bf), z(4, 64, 256), z(4, 256), z(4, 256, 64), z(4, 64))
    dout = z(4, 64, 64, dt=bf)
    assert torch.equal(TX.expert_ffn(*ffn), TX.expert_ffn_reference(*ffn))
    for g, w in zip(_grads_through_autograd(TX.expert_ffn, ffn, (), dout),
                    TX.expert_ffn_bwd_reference(*ffn, dout)):
        assert torch.equal(g, w.to(g.dtype))
    assert [c.count for c in counters] == before
    attn = (z(2, 16, 64, dt=bf), z(64), z(64), z(192, 64), z(192), z(64, 64), z(64))
    assert TT.attention_tier(2, 16, 64, 1) is None and TT.core_tier(2, 16, 64, 1) is None
    counters = (TA.LAUNCHES, TA.BWD_LAUNCHES, TA.CORE_LAUNCHES, TA.CORE_BWD_LAUNCHES,
                TF.FWD_LAUNCHES, TF.BWD_LAUNCHES)
    before = [c.count for c in counters]
    dout = z(2, 16, 64, dt=bf)
    _assert_bf16_rule(TA.fused_attention_block(*attn, 1), TA.rung3_block_reference(*attn, 1, None))
    _assert_grads_close(_grads_through_autograd(TA.fused_attention_block, attn, (1,), dout),
                        TA.rung3_block_bwd_reference(*attn, 1, dout, None))
    assert [c.count for c in counters] == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", [(4, 144, 384, 6), (8, 256, 384, 6), (2, 400, 384, 6),
                                     (2, 256, 128, 2), (8, 256, 768, 12), (1, 512, 128, 2)])
def test_k2_cores_past_128_tokens_match_plain_on_the_card(cuda_device, B, N, D, H):
    """The half-block at N = 144, 256, 400 (the DiT's 48, 64 and 80 px at
    patch 4) and 512 through the query-tile forward core and the two-pass
    backward: the forward by the bf16 rule, all seven gradients through
    autograd twice (bit-identical) against the plain backward; K2b or K4 by
    the JAX ladder's tier (K4 at DiT-B width)."""
    tier = TT.attention_tier(B, N, D, H)
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=19))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(20),
                       device=cuda_device).to(torch.bfloat16)
    counters = (TA.LAUNCHES, TA.BWD_LAUNCHES, TA.SPLIT_BWD_LAUNCHES)
    before = [c.count for c in counters]
    with torch.inference_mode():
        out = TA.fused_attention_block(*args, H)
    _assert_bf16_rule(out, TA.attention_block_reference(*args, H))
    got = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    again = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    torch.cuda.synchronize()
    split = tier == "split"
    assert [c.count - n for c, n in zip(counters, before)] == [3, 0 if split else 2,
                                                                2 if split else 0]
    _assert_grads_close(got, TA.attention_block_bwd_reference(*args, H, dout))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(64, 64, 6, 64), (16, 112, 6, 64), (8, 128, 4, 32),
                                      (4, 48, 2, 128), (64, 64, 16, 72), (16, 112, 16, 24)])
def test_k2_tiled_cores_agree_with_the_one_block_cores_on_the_card(cuda_device, B, N, H, Dh):
    """Where both backward designs take a shape, the two passes give the
    one-block core's bits: the same 16 x 16 products over the same depth
    slices in the same order, and P recomputed from the saved row max and
    sum."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    qkv = torch.randn(B, N, 3 * H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    datt = torch.randn(B, N, H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    tiled, single = TA._core_bwd_att(qkv, datt, H, "two-pass"), TA._core_bwd_att(
        qkv, datt, H, "one-block")
    assert torch.equal(tiled[0], single[0]) and torch.equal(tiled[1], single[1])
    want = TA.attention_core_bwd_att_reference(*qkv.split(H * Dh, dim=-1), datt, H)
    _assert_bf16_rule(tiled[1], torch.cat(want[1:], dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F,fast", [(16384, 384, 768, False), (1000, 128, 256, False),
                                        (131072, 768, 1536, False), (131072, 1152, 2304, False),
                                        (16384, 384, 768, True)])
def test_k6b_tp_partial_matches_plain_on_the_card(cuda_device, T, D, F, fast):
    """The tensor-parallel MLP partial through autograd at the ``--tp 2``
    shards (DiT-S's sampler rows, a small ragged case, DiT-B's and DiT-XL's
    training rows, the fast GELU): one K6f forward (fp32, by the partial rule)
    and K6b backward (K1b's chain on the wgmma ring) for an fp32 cotangent,
    against :func:`mlp_partial_bwd_reference` (dx by the bf16 rule, the fp32
    gradients by the gradient rule), twice, bit-identical; and K6b called
    directly gives the same bits."""
    inputs = _mlp_inputs(T, D, F, seed=31)
    del inputs["b2"]
    args = _on(cuda_device, inputs)
    do = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(32),
                     device=cuda_device)
    assert TT.mlp_tier(T, D, F)[0] in ("fused", "fwdonly")
    fn = lambda *a: TM.fused_mlp_partial(*a, fast_gelu=fast)  # noqa: E731
    before = (TM.PARTIAL_LAUNCHES.count, TM.PARTIAL_BWD_LAUNCHES.count, TM.BWD_LAUNCHES.count)
    with torch.inference_mode():
        part = fn(*args)
    got = _grads_through_autograd(fn, args, (), do)
    again = _grads_through_autograd(fn, args, (), do)
    direct = TM.mlp_partial_bwd(*args, do, fast_gelu=fast)
    torch.cuda.synchronize()
    assert (TM.PARTIAL_LAUNCHES.count - before[0], TM.PARTIAL_BWD_LAUNCHES.count - before[1],
            TM.BWD_LAUNCHES.count - before[2]) == (3, 3, 0)
    assert part.dtype == torch.float32
    _assert_partial_rule(part, lambda *a: TM.mlp_partial_reference(*a, fast_gelu=fast), args,
                         lambda a, pd, pf: (a[0][:, pd].contiguous(), a[1][pd], a[2][pd],
                                            a[3][pf][:, pd], a[4][pf], a[5][pd][:, pf]))
    del part
    _assert_grads_close(got, TM.mlp_partial_bwd_reference(*args, do, fast_gelu=fast))
    for g, h, d in zip(got, again, direct):
        assert torch.equal(g, h) and torch.equal(g, d.to(g.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["K10p", "K10p XL", "K6b", "K6b XL"])
def test_k10p_and_k6b_launch_no_wmma_product_on_the_card(cuda_device, monkeypatch, path):
    """With the WMMA launchers of ``ops/gemm.py`` made to raise, K10p's
    chunked forward (DiT-B's MoE, the XL MoE) and K6b (the DiT-B and DiT-XL
    shards) still pass their card tests: they launch only the wgmma products
    (and, for K6b, ``cast_bf16`` and ``ln_bwd``), with no fallback."""
    for name in WMMA_LAUNCHERS:
        monkeypatch.setattr(TX.gemm, name, _refuse_wmma)
    if path == "K10p":
        test_k10p_matches_plain_on_the_card(cuda_device, monkeypatch, 8, 20480, 768, 3072, 2,
                                            False, False, True)
    elif path == "K10p XL":
        test_k10p_matches_plain_on_the_card(cuda_device, monkeypatch, 8, 20480, 1152, 4608, 4,
                                            False, False, True)
    elif path == "K6b":
        test_k6b_tp_partial_matches_plain_on_the_card(cuda_device, 131072, 768, 1536, False)
    else:
        test_k6b_tp_partial_matches_plain_on_the_card(cuda_device, 131072, 1152, 2304, False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,core", [(256, 64, 384, 6, "K7"), (4, 64, 192, 3, None)])
def test_fused_attention_on_separate_tensors_on_the_card(cuda_device, B, N, D, H, core):
    """``fused_attention`` over three separate q, k, v (the tensor-parallel
    half-block's products): the core ``core_tier`` picks (K7f/K7b, or the
    plain core where JAX runs XLA's, as at the DiT-S --tp 2 local width),
    forward and backward through autograd by the bf16 rule against the plain
    versions, the backward twice, bit-identical."""
    assert TT.core_tier(B, N, D, H) == core
    gen = torch.Generator(device=cuda_device).manual_seed(33)
    q, k, v, do = (torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    before = (TA.CORE_LAUNCHES.count, TA.CORE_BWD_LAUNCHES.count)
    runs = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = TA.fused_attention(*leaves, H)
        o.backward(do)
        runs.append([o.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    n = 2 if core == "K7" else 0
    assert (TA.CORE_LAUNCHES.count - before[0], TA.CORE_BWD_LAUNCHES.count - before[1]) == (n, n)
    want = [TA.attention_reference(q, k, v, H), *TA.attention_core_bwd_reference(q, k, v, do, H)]
    for g, h, w in zip(*runs, want):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
def test_half_block_widths_past_1024_on_the_card(cuda_device):
    """D up to 1344 (the LN-prologue GEMM's resident panel: 200,704 bytes at
    DiT-XL's 1152) runs: K2f and K4 at D 1280 over 10 heads, K6f at D 1280
    (F 5120). Past it, at D 1536 (N = 64): the attention half-block takes
    the third rung's plain products around K7 (JAX runs XLA's there), and
    the MLP half-block, whose F-chunked tier JAX runs as a kernel, runs four
    K6f through the streamed LN-prologue GEMM (bf16 rule)."""
    assert TM.gemm.LN_GEMM_MAX_K == 1344 and TM.gemm.ln_gemm_smem(1152) == 200704
    assert TT.mlp_tier(1024, 1280, 5120) == ("fchunked", 2)
    args = _on(cuda_device, _mlp_inputs(1024, 1280, 5120, seed=34))
    with torch.inference_mode():
        _assert_bf16_rule(TM.fused_mlp_block(*args), TM.mlp_block_fchunked_reference(*args, 2))
    assert TT.attention_tier(8, 64, 1280, 10) == "split"
    attn = _on(cuda_device, _attn_inputs(8, 64, 1280, seed=33))
    dout = torch.randn(8, 64, 1280, generator=torch.Generator(device=cuda_device).manual_seed(3),
                       device=cuda_device).to(torch.bfloat16)
    with torch.inference_mode():
        _assert_bf16_rule(TA.fused_attention_block(*attn, 10),
                          TA.attention_block_reference(*attn, 10))
    _assert_grads_close(_grads_through_autograd(TA.fused_attention_block, attn, (10,), dout),
                        TA.attention_block_bwd_reference(*attn, 10, dout))
    wide = _on(cuda_device, _attn_inputs(2, 64, 1536, seed=35))
    assert TT.attention_tier(2048, 64, 1536, 16) is None and TT.core_tier(2, 64, 1536, 16) == "K7"
    before = [c.count for c in (TA.LAUNCHES, TA.CORE_LAUNCHES)]
    with torch.inference_mode():
        _assert_bf16_rule(TA.fused_attention_block(*wide, 16),
                          TA.rung3_block_reference(*wide, 16, "K7"))
    assert [c.count - n for c, n in zip((TA.LAUNCHES, TA.CORE_LAUNCHES), before)] == [0, 1]
    assert TT.mlp_tier(128, 1536, 6144) == ("fchunked", 4)
    mlp = _on(cuda_device, _mlp_inputs(128, 1536, 6144, seed=36))
    before = [c.count for c in (TM.LAUNCHES, TM.PARTIAL_LAUNCHES)]
    with torch.inference_mode():
        _assert_bf16_rule(TM.fused_mlp_block(*mlp), TM.mlp_block_fchunked_reference(*mlp, 4))
    assert [c.count - n for c, n in zip((TM.LAUNCHES, TM.PARTIAL_LAUNCHES), before)] == [0, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("epi", [0, 1, 2])
@pytest.mark.parametrize("T,D,Nout", [(1000, 1152, 4608), (4096, 1344, 1344 * 3),
                                      (300, 1344, 704)])
def test_streamed_ln_gemm_gives_the_panel_kernels_bits(cuda_device, T, D, Nout, epi):
    """The streamed LN-prologue GEMM (pass 1: row statistics in the panel
    kernel's order; pass 2: each x chunk normalised and rounded as the panel
    kernel rounds its panel) against the resident-panel kernel at depths both
    take: out, the fp32 GELU derivative and y = bf16(LN(x)) equal bit for
    bit, erf and fast GELU, ragged T and Nout included."""
    g = TM.gemm
    assert D <= g.LN_GEMM_MAX_K
    r = np.random.default_rng(40 + epi)
    x = _t((1.5 * r.standard_normal((T, D)) + 0.3).astype(np.float32)).to(cuda_device)
    x = x.to(torch.bfloat16)
    scale, bias = (_t((a + 0.1 * r.standard_normal(D)).astype(np.float32)).to(cuda_device)
                   for a in (1.0, 0.0))
    w = _t((D ** -0.5 * r.standard_normal((Nout, D))).astype(np.float32)).to(cuda_device)
    w = w.to(torch.bfloat16)
    b = _t((0.1 * r.standard_normal(Nout)).astype(np.float32)).to(cuda_device)
    for fast in (False, True):
        panel = g.ln_gemm(x, scale, bias, w, b, epi, with_y=True, fast_gelu=fast)
        stream = g.ln_gemm(x, scale, bias, w, b, epi, with_y=True, fast_gelu=fast, streamed=True)
        torch.cuda.synchronize()
        for p, q in zip(panel, stream):
            assert (p is None) == (q is None)
            if p is not None:
                assert torch.equal(p, q)


# (T, D, F, tier): the MLP half-block past D 1344 at every kind of tier the
# JAX ladder sends there at T 1024: fwdonly (ratio 1 at D 1408, 1792),
# fchunked at ratios 4, 2 and 1 (D 1536, 2048; 3072; 4096)
WIDE_MLP = [(1024, 1408, 1408, ("fwdonly", 1)), (1024, 1536, 6144, ("fchunked", 8)),
            (1024, 1792, 1792, ("fwdonly", 1)), (1024, 2048, 8192, ("fchunked", 8)),
            (1024, 3072, 6144, ("fchunked", 8)), (1024, 4096, 4096, ("fchunked", 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F,tier", WIDE_MLP)
def test_mlp_half_block_past_1344_matches_plain_on_the_card(cuda_device, T, D, F, tier):
    """K1f (``fwdonly``) or k K6f (``fchunked``) forward by the bf16 rule
    against the plain version of its tier, and K1b's chain through autograd
    (the streamed recompute; at D 4096 the 4-warp LayerNorm backward) by the
    gradient rule, twice, bit-identical; each launch counted."""
    assert TT.mlp_tier(T, D, F) == tier
    args = _on(cuda_device, _mlp_inputs(T, D, F, seed=41))
    kind, k = tier
    counters = (TM.LAUNCHES, TM.PARTIAL_LAUNCHES, TM.BWD_LAUNCHES)
    before = [c.count for c in counters]
    with torch.inference_mode():
        out = TM.fused_mlp_block(*args)
    plain = (TM.mlp_block_reference(*args) if kind == "fwdonly" else
             TM.mlp_block_fchunked_reference(*args, k))
    _assert_bf16_rule(out, plain)
    dout = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(42),
                       device=cuda_device).to(torch.bfloat16)
    got, again = (_grads_through_autograd(TM.fused_mlp_block, args, (), dout) for _ in range(2))
    torch.cuda.synchronize()
    fwd = (1, 0) if kind == "fwdonly" else (0, k)
    assert [c.count - n for c, n in zip(counters, before)] == [fwd[0] * 3, fwd[1] * 3, 2]
    _assert_grads_close(got, TM.mlp_block_bwd_reference(*args, dout))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [3584, 4096])
def test_ln_bwd_past_3584_matches_plain_on_the_card(cuda_device, D):
    """The LayerNorm backward with the residual at D 3584 (8 warps a block,
    the widest whose 2 x D partials fit) and D 4096 (4 warps): dx by the
    bf16 rule, dscale and dbias by the gradient rule against
    ``layer_norm_bwd``, a second call bit-identical."""
    T = 1000
    r = np.random.default_rng(43)
    x = _t(r.standard_normal((T, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    dy = _t(r.standard_normal((T, D)).astype(np.float32)).to(cuda_device)
    dres = _t(r.standard_normal((T, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    scale = _t((1 + 0.1 * r.standard_normal(D)).astype(np.float32)).to(cuda_device)
    got, again = (TM.gemm.ln_bwd(x, dy, dres, scale) for _ in range(2))
    torch.cuda.synchronize()
    xhat, inv = TM.ln_stats(x.float())
    want = TM.layer_norm_bwd(dy, xhat, inv, scale, dres.float())
    _assert_grads_close(got, want)
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def _fast_mlp(cuda_device, T, D, F, seed):
    """MLP inputs whose h spreads over |h| <= ~6, where the GELUs differ most."""
    inputs = _mlp_inputs(T, D, F, seed=seed)
    inputs["w1"] = inputs["w1"] * 2.0
    return _on(cuda_device, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F,tier", [(16384, 384, 1536, ("fused", 1)),
                                        (16384, 1024, 4096, ("fchunked", 2))])
def test_fast_gelu_mlp_kernels_match_plain_on_the_card(cuda_device, T, D, F, tier):
    """``fast_gelu`` in K1f (or two K6f in the F-chunked tier) and K1b's
    recompute: the forward by the bf16 rule against the plain version with
    the sigmoid GELU (and away from the erf one), the seven gradients twice
    (bit-identical) against the plain backward with it."""
    assert TT.mlp_tier(T, D, F) == tier
    args = _fast_mlp(cuda_device, T, D, F, seed=36)
    with torch.inference_mode():
        out = TM.fused_mlp_block(*args, fast_gelu=True)
    plain = (TM.mlp_block_reference(*args, fast_gelu=True) if tier[0] == "fused" else
             TM.mlp_block_fchunked_reference(*args, 2, fast_gelu=True))
    _assert_bf16_rule(out, plain)
    assert float((out.float() - TM.mlp_block_reference(*args).float()).abs().max()) > 0.01
    dout = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(37),
                       device=cuda_device).to(torch.bfloat16)
    got = _grads_through_autograd(lambda *a: TM.fused_mlp_block(*a, fast_gelu=True), args, (),
                                  dout)
    again = _grads_through_autograd(lambda *a: TM.fused_mlp_block(*a, fast_gelu=True), args, (),
                                    dout)
    _assert_grads_close(got, TM.mlp_block_bwd_reference(*args, dout, fast_gelu=True))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_fast_gelu_tp_partial_matches_plain_on_the_card(cuda_device):
    """``fast_gelu`` in K6f's tensor-parallel entry (fp32, the partial rule)
    and K6b (the gradient rule, twice, bit-identical)."""
    inputs = _mlp_inputs(16384, 384, 768, seed=38)
    inputs["w1"] = inputs["w1"] * 2.0
    del inputs["b2"]
    args = _on(cuda_device, inputs)
    do = torch.randn(16384, 384, generator=torch.Generator(device=cuda_device).manual_seed(39),
                     device=cuda_device)
    with torch.inference_mode():
        part = TM.fused_mlp_partial(*args, fast_gelu=True)
    _assert_partial_rule(part, lambda *a: TM.mlp_partial_reference(*a, fast_gelu=True), args,
                         lambda a, pd, pf: (a[0][:, pd].contiguous(), a[1][pd], a[2][pd],
                                            a[3][pf][:, pd], a[4][pf], a[5][pd][:, pf]))
    fn = lambda *a: TM.fused_mlp_partial(*a, fast_gelu=True)  # noqa: E731
    got, again = (_grads_through_autograd(fn, args, (), do) for _ in range(2))
    _assert_grads_close(got, TM.mlp_partial_bwd_reference(*args, do, fast_gelu=True))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,D,F,tier", [(8, 2048, 384, 1536, ("fused", 1)),
                                          (8, 2048, 768, 3072, ("fwdonly", 2))])
def test_fast_gelu_expert_kernels_match_plain_on_the_card(cuda_device, E, S, D, F, tier):
    """``fast_gelu`` in K10f (or two K10p) and K10b's recompute: forward by
    the bf16 rule, five gradients twice (bit-identical) by the gradient
    rule, against the plain versions with the sigmoid GELU."""
    assert TT.expert_tier(E, S, D, F) == tier
    r = np.random.default_rng(40)
    x = r.standard_normal((E, S, D)).astype(np.float32)
    x[:, S - S // 5:] = 0.0
    args = [_t(x).to(cuda_device).to(torch.bfloat16)] + [_t(a).to(cuda_device) for a in (
        (2 * D ** -0.5 * r.standard_normal((E, D, F))).astype(np.float32),
        (0.1 * r.standard_normal((E, F))).astype(np.float32),
        (F ** -0.5 * r.standard_normal((E, F, D))).astype(np.float32),
        (0.1 * r.standard_normal((E, D))).astype(np.float32))]
    dout = _t(r.standard_normal((E, S, D)).astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    with torch.inference_mode():
        out = TX.expert_ffn(*args, fast_gelu=True)
    _assert_bf16_rule(out, TX.expert_ffn_reference(*args, fast_gelu=True) if tier[1] == 1 else
                      TX.expert_ffn_fchunked_reference(*args, 2, fast_gelu=True))
    fn = lambda *a: TX.expert_ffn(*a, fast_gelu=True)  # noqa: E731
    got, again = (_grads_through_autograd(fn, args, (), dout) for _ in range(2))
    _assert_grads_close(got, TX.expert_ffn_bwd_reference(*args, dout, fast_gelu=True))
    for g, h in zip(got, again):
        assert torch.equal(g, h)


def _earlier_fwd(N, Dh):
    """The forward design the plan picked before the registers designs:
    resident where its tile fits, else streamed."""
    try:
        TA.core_plan(N, Dh, False, "resident")
        return "resident"
    except RuntimeError:
        return "streamed"


def _earlier_bwd(N, Dh):
    """The backward design the plan picked before the registers design: one
    block per (image, head) where it fits, else two whole-head passes, else
    streamed."""
    for design in ("one-block", "two-pass", "streamed"):
        try:
            TA.core_plan(N, Dh, True, design)
            return design
        except RuntimeError:
            continue
    raise AssertionError(f"no earlier backward design takes N={N}, Dh={Dh}")


def _core_case(device, B, N, H, Dh, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * Dh, generator=gen, device=device).to(torch.bfloat16)
    do = torch.randn(B, N, H * Dh, generator=gen, device=device).to(torch.bfloat16)
    return qkv, do


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh,att", [(8, 256, 1, 384, True), (16, 64, 1, 768, True),
                                          (8, 256, 2, 512, False), (2, 16, 1, 3712, False),
                                          (2, 144, 1, 3328, False), (2, 256, 1, 1792, False),
                                          (2, 400, 1, 1024, False)])
def test_streamed_cores_match_plain_on_the_card(cuda_device, B, N, H, Dh, att):
    """The cores past 227 KB of shared memory: DiT-S/4 --heads 1 at 64 px and
    DiT-B/4 --heads 1 (K2b's and K4's core, writing att), DiT-L/4 --heads 2
    at 64 px (K7b, no att) and the widest head the JAX gates send at each N,
    forward and backward against their plain versions by the bf16 rule, the
    backward twice, bit-identical. The plan takes the wide registers
    backward up to a padded head of 896 (the three paths) and streams a pass
    past it. att is the forward core's bit for bit: the wide registers
    forward's up to 896, else the earlier forward's (resident or streamed,
    forced), which the plan's forward is held to by the bf16 rule."""
    qkv, do = _core_case(cuda_device, B, N, H, Dh, seed=30)
    D = H * Dh
    q, k, v = qkv.split(D, dim=-1)
    wide = -(-Dh // 16) * 16 <= 896
    assert TA.core_plan(N, Dh, backward=True)["design"] == ("registers" if wide else "streamed")
    o = TA.attention_core_fwd(q, k, v, H)
    _assert_bf16_rule(o, TA.attention_reference(q, k, v, H))
    if att:
        got, again = TA._core_bwd_att(qkv, do, H), TA._core_bwd_att(qkv, do, H)
        want = TA.attention_core_bwd_att_reference(q, k, v, do, H)
        earlier = TA._launch_core(q, k, v, H, _earlier_fwd(N, Dh))
        assert torch.equal(got[0], o if wide else earlier)  # att: the paired forward's bits
        _assert_bf16_rule(o, earlier)
        got, again = (got[0], *got[1].split(D, dim=-1)), (again[0], *again[1].split(D, dim=-1))
    else:
        got, again = TA.attention_core_bwd(q, k, v, do, H), TA.attention_core_bwd(q, k, v, do, H)
        want = TA.attention_core_bwd_reference(q, k, v, do, H)
    torch.cuda.synchronize()
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(64, 64, 6, 64), (8, 256, 4, 256), (4, 512, 2, 64),
                                      (8, 256, 4, 72), (16, 112, 6, 64)])
def test_streamed_cores_give_the_resident_bits_on_the_card(cuda_device, B, N, H, Dh):
    """Where a resident design takes a shape, the streamed one gives its bits:
    the forward core, and the backward (att, dq, dk, dv) against the two
    whole-head passes or, at (112, 64), the one-block core; each backward
    twice, bit-identical. At Dh 256 and 72 (80 padded) the streamed design
    takes several 64-column chunks. The plan's own picks are the registers
    designs, forward and backward, at every one of these widths (the fused
    backward block at N <= 64 up to 128 columns, the wide designs at Dh
    256)."""
    qkv, do = _core_case(cuda_device, B, N, H, Dh, seed=31)
    resident = "one-block" if N <= 112 else "two-pass"
    assert TA.core_plan(N, Dh, backward=True)["design"] == (
        "registers-fused" if N <= 64 and Dh <= 128 else "registers")
    assert TA.core_plan(N, Dh)["design"] == "registers"
    assert torch.equal(TA._k2_core(qkv, H, "streamed"), TA._k2_core(qkv, H, "resident"))
    outs = {d: [TA._core_bwd_att(qkv, do, H, d) for _ in range(2)] for d in (resident, "streamed")}
    torch.cuda.synchronize()
    for first, second in outs.values():
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    (att, dqkv), (satt, sdqkv) = outs[resident][0], outs["streamed"][0]
    assert torch.equal(att, satt) and torch.equal(dqkv, sdqkv)
    assert torch.equal(att, TA._k2_core(qkv, H, "resident"))
    want = TA.attention_core_bwd_att_reference(*qkv.split(H * Dh, dim=-1), do, H)
    _assert_bf16_rule(sdqkv, torch.cat(want[1:], dim=-1))


@pytest.mark.cuda
def test_core_plan_on_the_card(cuda_device):
    """The library's plan, which the launchers take: the registers designs up
    to a padded head of 128 columns (the forward's with 64 query rows a
    block, 128 past N 128 where they divide N; the backward's fused block
    at N <= 64, its dq and dk/dv sides past it, 64 rows a block each), the
    wide registers designs past it up to 896 (the forward's 64 query rows a
    block up to a padded 512 where their scores fit, else 32; the
    backward's dq side 32 rows a block, 16 where their scores do not fit,
    its dk/dv side 64, 32 or 16 key rows by the width), the one-block
    backward forced up to N 112 at Dh 64 (128 at Dh 32), the whole-head
    designs where they fit, streamed passes past 227 KB (forced, or past
    896), and a refusal where a forced design does not fit."""
    plan = TA.core_plan
    assert plan(112, 64, True, "one-block")["design"] == "one-block"
    assert plan(128, 64, True, "two-pass")["design"] == "two-pass"
    assert plan(128, 32, True, "one-block")["design"] == "one-block"
    assert plan(112, 64, True) == {"design": "registers", "rows": (64, 64),
                                   "cols": (64, 64, 64, 64)}
    assert plan(64, 72, True) == {"design": "registers-fused", "rows": (64, 80),
                                  "cols": (64, 64, 80, 80)}
    assert plan(256, 24, True)["design"] == "registers"
    assert plan(256, 72, True)["cols"] == (64, 32, 80, 80)  # 32-query stages past 64 columns
    assert plan(64, 64, True, "registers")["design"] == "registers"
    assert plan(64, 136, True) == {"design": "registers", "rows": (32, 144),
                                   "cols": (64, 64, 144, 144)}
    assert plan(128, 136, True, "two-pass")["design"] == "two-pass"
    assert plan(256, 384, True) == {"design": "registers", "rows": (32, 384),
                                    "cols": (32, 64, 384, 384)}
    assert plan(64, 768, True) == {"design": "registers", "rows": (32, 768),
                                   "cols": (16, 64, 768, 768)}
    assert plan(512, 896, True)["rows"] == (16, 896)  # 32 rows' scores would not fit
    assert plan(256, 904, True)["design"] == "streamed"
    assert plan(256, 64) == {"design": "registers", "QT": 128, "C": 64}
    assert plan(64, 72) == {"design": "registers", "QT": 64, "C": 80}
    assert plan(272, 128) == {"design": "registers", "QT": 64, "C": 128}
    assert plan(256, 64, False, "resident") == {"design": "resident", "QT": 32, "C": 64}
    assert plan(256, 136) == {"design": "registers", "QT": 64, "C": 144}
    assert plan(256, 384) == {"design": "registers", "QT": 64, "C": 384}
    assert plan(256, 512) == {"design": "registers", "QT": 64, "C": 512}
    assert plan(512, 384) == {"design": "registers", "QT": 32, "C": 384}
    assert plan(64, 768) == {"design": "registers", "QT": 32, "C": 768}
    assert plan(512, 896) == {"design": "registers", "QT": 32, "C": 896}
    assert plan(256, 136, False, "resident")["design"] == "resident"
    assert plan(256, 384, False, "streamed") == {"design": "streamed", "QT": 32, "C": 64}
    assert plan(64, 768, False, "resident")["design"] == "resident"
    assert plan(64, 904)["design"] == "resident"
    s = plan(256, 384, True, "streamed")
    assert s["design"] == "streamed" and s["rows"] == (16, 64) and s["cols"][2] == 64
    assert plan(64, 768, True, "streamed")["rows"] == (32, 64)
    assert plan(16, 3712, True)["cols"] == (16, 16, 64, 928)
    for args in ((256, 384, False, "resident"), (256, 384, True, "two-pass"),
                 (256, 64, True, "one-block"), (528, 64, False, None), (64, 68, True, None),
                 (256, 904, False, "registers"), (528, 64, False, "registers"),
                 (64, 904, True, "registers"), (80, 64, True, "registers-fused"),
                 (64, 136, True, "registers-fused")):
        with pytest.raises(RuntimeError):
            plan(*args)
    attrs = TA.kernel_attrs()
    assert set(attrs) == set(TA.CORE_KERNELS)
    assert all(a["registers"] > 0 and a["local_bytes"] >= 0 for a in attrs.values())


# The registers design's classes: a warp holds its scores (one key tile at
# N <= 64, two at N <= 128), else the two sweeps on 4 warps (N % 128 != 0)
# or on 8 (128-row query tiles); ragged key and query tiles (N % 64 != 0);
# every padded width 16-128 (Dh 8, 24, 40, 72, 120 padded, 32, 64, 128 not)
REGISTERS_SHAPES = [(64, 16, 6, 64), (32, 48, 2, 72), (64, 64, 16, 24), (16, 80, 4, 40),
                    (16, 112, 2, 96), (8, 128, 3, 128), (8, 144, 4, 8), (8, 192, 2, 112),
                    (4, 272, 2, 120), (64, 256, 6, 64), (16, 256, 16, 72), (4, 400, 3, 32),
                    (2, 512, 2, 128), (4, 384, 6, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", REGISTERS_SHAPES)
def test_registers_core_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """The registers forward core, the plan's pick at every padded head up
    to 128 columns, against its plain version by the bf16 rule, and within
    the same rule of the resident design forced on the same q, k, v (read in
    place from a [q | k | v] buffer, and from three tensors)."""
    qkv, _ = _core_case(cuda_device, B, N, H, Dh, seed=33)
    q, k, v = qkv.split(H * Dh, dim=-1)
    assert TA.core_plan(N, Dh)["design"] == "registers"
    with torch.no_grad():
        got = TA._launch_core(q, k, v, H)
        forced = TA._launch_core(q, k, v, H, "registers")
        apart = TA._launch_core(*(t.contiguous() for t in (q, k, v)), H)
        resident = TA._launch_core(q, k, v, H, "resident")
        torch.cuda.synchronize()
    assert torch.equal(got, forced) and torch.equal(got, apart)
    _assert_bf16_rule(got, TA.attention_reference(q, k, v, H))
    _assert_bf16_rule(got, resident)


@pytest.mark.cuda
def test_registers_core_refuses_wider_heads_on_the_card(cuda_device):
    """Forced past a padded head of 896 columns the registers design raises
    (no fallback to another design); the plan takes the resident design
    there."""
    qkv, _ = _core_case(cuda_device, 2, 64, 1, 904, seed=34)
    with pytest.raises(RuntimeError, match="attention_core"):
        TA._k2_core(qkv, 1, "registers")
    assert TA.core_plan(64, 904)["design"] == "resident"


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(2, 1024, 12, 32), (2, 1024, 6, 64), (2, 1024, 3, 128),
                                      (1, 4096, 2, 64), (3, 128, 4, 32), (1, 192, 2, 128)])
def test_k8f_registers_design_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K8f's registers design (its own pick at Dh 32, 64, 128) against the
    plain version (o by the bf16 rule, lse to 1e-5 relative) and within the
    bf16 rule of the tiles design forced on the same q, k, v; K8b on the
    registers forward's o and lse against its plain version, twice,
    bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(35)
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = Dh ** -0.5
    o, lse = TF.flash_attention_fwd(q, k, v, H)
    forced = TF.launch_k8f(q, k, v, H, scale, "registers")
    tiles = TF.launch_k8f(q, k, v, H, scale, "tiles")
    grads = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    again = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    assert torch.equal(o, forced[0]) and torch.equal(lse, forced[1])
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    _assert_bf16_rule(o, tiles[0])
    torch.testing.assert_close(lse, tiles[1], rtol=1e-5, atol=0)
    for g, h, w in zip(grads, again, TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)


# K8 at the narrow widths: the 3o rows' head counts (D 384 over 96, 48, 24
# heads) at fewer images, N 1024 and 2304 (whole 128-query blocks of the
# forward) and 1600 (its last block half past N)
NARROW_SHAPES = [(2, 1024, 96, 4), (2, 1024, 48, 8), (2, 1024, 24, 16), (1, 2304, 24, 16),
                 (1, 2304, 96, 4), (1, 1600, 48, 8), (1, 1600, 24, 16)]


def _narrow_case(cuda_device, B, N, H, Dh, seed):
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    return (*qkv.split(D, dim=-1), do)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", NARROW_SHAPES)
def test_k8f_narrow_registers_design_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K8f's narrow registers design (its own pick at Dh 4, 8, 16; q, k, v
    read in place from a [q | k | v] buffer, a Dh-4 head on an 8-byte
    boundary) against the plain version (o by the bf16 rule, lse to 1e-5
    relative), the design forced by name bit-identical, and within the
    bf16 rule of the tiles design forced on the same q, k, v."""
    q, k, v, _ = _narrow_case(cuda_device, B, N, H, Dh, seed=41)
    scale = Dh ** -0.5
    with torch.no_grad():
        o, lse = TF.flash_attention_fwd(q, k, v, H)
        forced = TF.launch_k8f(q, k, v, H, scale, "registers")
        tiles = TF.launch_k8f(q, k, v, H, scale, "tiles")
        torch.cuda.synchronize()
    assert torch.equal(o, forced[0]) and torch.equal(lse, forced[1])
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    _assert_bf16_rule(o, tiles[0])
    torch.testing.assert_close(lse, tiles[1], rtol=1e-5, atol=0)


# The wide registers core (padded widths 144-896): 64 query rows a block on
# 16 warps (up to a padded 512, where their scores fit) or 32 on 8; ragged
# key and query tiles (N % 64 != 0), padded heads (136 -> 144,
# 200 -> 208, 264 -> 272, 632 -> 640, 904 is past it) and whole ones
WIDE_REGISTERS_SHAPES = [(4, 16, 1, 896), (8, 48, 2, 136), (16, 80, 2, 136), (16, 64, 1, 768),
                         (4, 144, 2, 200), (8, 256, 1, 384), (4, 256, 2, 512), (2, 272, 1, 264),
                         (2, 400, 1, 632), (1, 512, 1, 896), (2, 512, 1, 384), (8, 256, 4, 256),
                         (4, 112, 3, 152)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", WIDE_REGISTERS_SHAPES)
def test_wide_registers_core_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """The wide registers forward core, the plan's pick past a padded head
    of 128 columns, against its plain version by the bf16 rule, and within
    the same rule of the earlier design forced (resident, or streamed past
    227 KB) on the same q, k, v (read in place from a [q | k | v] buffer,
    and from three tensors: the same bits)."""
    qkv, _ = _core_case(cuda_device, B, N, H, Dh, seed=36)
    q, k, v = qkv.split(H * Dh, dim=-1)
    plan = TA.core_plan(N, Dh)
    assert plan["design"] == "registers" and plan["QT"] in (32, 64)
    before = TA.CORE_LAUNCHES.count
    with torch.no_grad():
        got = TA._launch_core(q, k, v, H)
        forced = TA._launch_core(q, k, v, H, "registers")
        apart = TA.attention_core_fwd(*(t.contiguous() for t in (q, k, v)), H)
        earlier = TA._launch_core(q, k, v, H, _earlier_fwd(N, Dh))
        torch.cuda.synchronize()
    assert TA.CORE_LAUNCHES.count == before + 1  # K7f's entry point counts its call
    assert torch.equal(got, forced) and torch.equal(got, apart)
    _assert_bf16_rule(got, TA.attention_reference(q, k, v, H))
    _assert_bf16_rule(got, earlier)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(2, 1024, 2, 256), (1, 1024, 2, 384), (1, 1024, 1, 512),
                                      (1, 1024, 1, 640), (1, 1024, 1, 768), (1, 1024, 1, 896),
                                      (3, 128, 2, 256), (1, 192, 1, 768), (1, 4096, 1, 256)])
def test_k8f_wide_registers_design_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K8f's wide registers design (its own pick at Dh 256-896) against the
    plain version (o by the bf16 rule, lse to 1e-5 relative) and within the
    same rules of the tiles design (the chunked kernel) forced on the same
    q, k, v; K8b as picked on the new o and lse against its plain version,
    twice, bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = Dh ** -0.5
    o, lse = TF.flash_attention_fwd(q, k, v, H)
    forced = TF.launch_k8f(q, k, v, H, scale, "registers")
    tiles = TF.launch_k8f(q, k, v, H, scale, "tiles")
    grads = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    again = TF.flash_attention_bwd(q, k, v, o, lse, do, H)
    torch.cuda.synchronize()
    assert torch.equal(o, forced[0]) and torch.equal(lse, forced[1])
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    _assert_bf16_rule(o, tiles[0])
    torch.testing.assert_close(lse, tiles[1], rtol=1e-5, atol=0)
    for g, h, w in zip(grads, again, TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)):
        assert torch.equal(g, h)
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
def test_wide_registers_kernels_do_not_spill_on_the_card(cuda_device):
    """No wide registers instance (K8f at Dh 256-896, the core's nine)
    takes local memory on the card."""
    wide = {k: v for k, v in TF.kernel_attrs().items() if k[0] == "registers" and k[1] > 128}
    assert sorted(k[1] for k in wide) == list(TF.WIDE_DIMS)
    core = {k: v for k, v in TA.kernel_attrs().items() if k.endswith(" rows")}
    assert len(core) == 9
    for name, a in {**wide, **core}.items():
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 255, name


# The backward's registers designs: the fused block (N <= 64) and the dq
# and dk/dv sides, at ragged key and query tiles (N % 64 != 0) and every
# padded width 16-128 (Dh 8, 24, 40, 72, 120 padded; 32, 64, 128 not)
REGISTERS_BWD_SHAPES = [(64, 16, 6, 64), (32, 48, 2, 72), (64, 64, 16, 24), (16, 80, 4, 40),
                        (16, 112, 2, 96), (8, 128, 3, 128), (8, 144, 4, 8), (8, 192, 2, 112),
                        (4, 272, 2, 120), (64, 256, 6, 64), (16, 256, 16, 72), (4, 400, 3, 32),
                        (2, 512, 2, 128), (4, 384, 6, 48), (16, 64, 3, 128), (8, 32, 2, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("att", [True, False])
@pytest.mark.parametrize("B,N,H,Dh", REGISTERS_BWD_SHAPES)
def test_registers_bwd_core_matches_plain_on_the_card(cuda_device, B, N, H, Dh, att):
    """The backward core's registers design, the plan's pick at every padded
    head up to 128 columns (fused at N <= 64), with att (K2b, K4) and
    without (K7b): against its plain version by the bf16 rule, a second call
    bit-identical, q, k, v read in place or from three tensors alike; each
    registers design that takes the shape forced by name, within the bf16
    rule of the earlier design forced on the same inputs."""
    qkv, do = _core_case(cuda_device, B, N, H, Dh, seed=36)
    D = H * Dh
    q, k, v = qkv.split(D, dim=-1)
    pick = TA.core_plan(N, Dh, backward=True)["design"]
    assert pick == ("registers-fused" if N <= 64 else "registers")
    designs = ("registers", "registers-fused") if N <= 64 else ("registers",)

    def run(design=None, operands=(q, k, v)):
        att_out, dqkv = TA._launch_core_bwd(*operands, do, H, att, design)
        return ((att_out,) if att else ()) + tuple(dqkv.split(D, dim=-1))

    with torch.no_grad():
        got, again = run(), run()
        apart = run(operands=tuple(t.contiguous() for t in (q, k, v)))
        forced = {d: run(d) for d in designs}
        earlier = run(_earlier_bwd(N, Dh))
        torch.cuda.synchronize()
    want = (TA.attention_core_bwd_att_reference if att else TA.attention_core_bwd_reference)(
        q, k, v, do, H)
    for g, h, a, f in zip(got, again, apart, forced[pick]):
        assert torch.equal(g, h) and torch.equal(g, a) and torch.equal(g, f)
    for out in forced.values():
        for g, w, e in zip(out, want, earlier):
            _assert_bf16_rule(g, w)
            _assert_bf16_rule(g, e)


@pytest.mark.cuda
def test_registers_bwd_core_refuses_what_it_does_not_take_on_the_card(cuda_device):
    """Forced past a padded head of 896 columns (the registers design), or of
    128 or past N 64 (the fused block), the registers designs raise (no
    fallback to another design)."""
    qkv, do = _core_case(cuda_device, 2, 64, 1, 904, seed=37)
    for design in ("registers", "registers-fused"):
        with pytest.raises(RuntimeError, match="attention core plan"):
            TA._core_bwd_att(qkv, do, 1, design)
    qkv, do = _core_case(cuda_device, 2, 64, 2, 136, seed=37)
    with pytest.raises(RuntimeError, match="attention core plan"):
        TA._core_bwd_att(qkv, do, 2, "registers-fused")
    qkv, do = _core_case(cuda_device, 2, 80, 2, 64, seed=38)
    with pytest.raises(RuntimeError, match="attention core plan"):
        TA._core_bwd_att(qkv, do, 2, "registers-fused")
    assert TA.core_plan(64, 136, True)["design"] == "registers"
    assert TA.core_plan(64, 904, True)["design"] == "streamed"


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", [(2, 1024, 12, 32), (2, 1024, 6, 64), (2, 1024, 3, 128),
                                      (1, 4096, 2, 64), (3, 128, 4, 32), (1, 192, 2, 128),
                                      (2, 1024, 2, 256), (1, 1024, 2, 384), (1, 1024, 1, 512),
                                      (1, 1024, 1, 640), (1, 1024, 1, 768), (1, 1024, 1, 896),
                                      (3, 128, 2, 256), (1, 192, 1, 768), (1, 4096, 1, 256),
                                      (2, 64, 3, 384)])
def test_k8b_registers_design_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K8b's registers design (its own pick at Dh 32-896; the wide design
    past 128) on the registers forward's o and lse: against the plain
    version by the bf16 rule, a second call and the design forced by name
    bit-identical, and within the bf16 rule of the tiles design forced on
    the same inputs (the chunked kernels past 128)."""
    gen = torch.Generator(device=cuda_device).manual_seed(39)
    D = H * Dh
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = Dh ** -0.5
    with torch.no_grad():
        o, lse = TF.flash_attention_fwd(q, k, v, H)
        got, again, forced, tiles = (TF.launch_k8b(q, k, v, o, lse, do, H, scale, d)
                                     for d in (None, None, "registers", "tiles"))
        torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, forced)
    want = TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)
    for g, w, e in zip(got.split(D, dim=-1), want, tiles.split(D, dim=-1)):
        _assert_bf16_rule(g, w)
        _assert_bf16_rule(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", NARROW_SHAPES)
def test_k8b_narrow_registers_design_matches_plain_on_the_card(cuda_device, B, N, H, Dh):
    """K8b's narrow registers design (its own pick at Dh 4, 8, 16) on the
    narrow registers forward's o and lse: dq, dk and dv against the plain
    version by the bf16 rule, the design forced by name bit-identical, and
    within the bf16 rule of the tiles design forced on the same inputs;
    dsum is the tiles design's bits (row_dot's order in both)."""
    q, k, v, do = _narrow_case(cuda_device, B, N, H, Dh, seed=42)
    D, scale = H * Dh, Dh ** -0.5
    with torch.no_grad():
        o, lse = TF.flash_attention_fwd(q, k, v, H)
        got, forced, tiles = (TF.launch_k8b(q, k, v, o, lse, do, H, scale, d)
                              for d in (None, "registers", "tiles"))
        torch.cuda.synchronize()
    assert torch.equal(got, forced)
    want = TF.flash_attention_bwd_reference(q, k, v, o, lse, do, H)
    for g, w, e in zip(got.split(D, dim=-1), want, tiles.split(D, dim=-1)):
        _assert_bf16_rule(g, w)
        _assert_bf16_rule(g, e)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", NARROW_SHAPES[:3])
def test_k8b_narrow_second_call_is_bit_identical_on_the_card(cuda_device, B, N, H, Dh):
    """No atomics: a second K8b call at the narrow widths, through the
    autograd function as the model calls it, gives the same bits."""
    q, k, v, do = _narrow_case(cuda_device, B, N, H, Dh, seed=43)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    grads = [torch.autograd.grad(TF.flash_attention(*leaves, H), leaves, do) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H,Dh", NARROW_SHAPES[:3] + NARROW_SHAPES[-1:])
def test_k8_tiles_forced_still_runs_at_the_narrow_widths_on_the_card(cuda_device, B, N, H, Dh):
    """"tiles", forced, still launches the kNarrow tiles kernels at Dh 4-16:
    o, lse, dq, dk and dv against the plain versions on its own o and lse."""
    q, k, v, do = _narrow_case(cuda_device, B, N, H, Dh, seed=44)
    D, scale = H * Dh, Dh ** -0.5
    with torch.no_grad():
        o, lse = TF.launch_k8f(q, k, v, H, scale, "tiles")
        dqkv = TF.launch_k8b(q, k, v, o, lse, do, H, scale, "tiles")
        torch.cuda.synchronize()
    want_o, want_lse = TF.flash_attention_reference(q, k, v, H)
    _assert_bf16_rule(o, want_o)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    for g, w in zip(dqkv.split(D, dim=-1), TF.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                                             H)):
        _assert_bf16_rule(g, w)


@pytest.mark.cuda
def test_narrow_registers_kernels_do_not_spill_on_the_card(cuda_device):
    """The narrow registers instances (K8f's forward, K8b's dq and dk/dv
    kernels, one each for Dh 4, 8, 16) take no local memory on the card."""
    attrs = TF.kernel_attrs()
    narrow = {k: a for k, a in attrs.items() if k[0].startswith("registers") and k[1] == 16}
    assert sorted(k[0] for k in narrow) == ["registers", "registers dk dv", "registers dq"]
    for name, a in narrow.items():
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 255, name


@pytest.mark.cuda
@pytest.mark.parametrize("att", [True, False])
@pytest.mark.parametrize("B,N,H,Dh", WIDE_REGISTERS_SHAPES)
def test_wide_registers_bwd_core_matches_plain_on_the_card(cuda_device, B, N, H, Dh, att):
    """The backward core's registers design past a padded head of 128 (the
    plan's pick up to 896: the wide dq side, 32 or 16 query rows a block,
    and the dk/dv side shared with K8b) at ragged tiles and padded heads:
    against the plain version by the bf16 rule and within it of the earlier
    design forced (one block, two passes or streamed); a second call, the
    design forced by name and q, k, v as three tensors bit-identical; att
    the wide forward core's output bit for bit."""
    qkv, do = _core_case(cuda_device, B, N, H, Dh, seed=40)
    D = H * Dh
    q, k, v = qkv.split(D, dim=-1)
    plan = TA.core_plan(N, Dh, backward=True)
    assert plan["design"] == "registers" and plan["rows"][0] in (16, 32)
    assert plan["cols"][0] in (16, 32, 64) and plan["cols"][1] == 64

    def run(design=None, operands=(q, k, v)):
        att_out, dqkv = TA._launch_core_bwd(*operands, do, H, att, design)
        return ((att_out,) if att else ()) + tuple(dqkv.split(D, dim=-1))

    with torch.no_grad():
        got, again, forced = run(), run(), run("registers")
        apart = run(operands=tuple(t.contiguous() for t in (q, k, v)))
        earlier = run(_earlier_bwd(N, Dh))
        fwd = TA._launch_core(q, k, v, H)
        torch.cuda.synchronize()
    want = (TA.attention_core_bwd_att_reference if att else TA.attention_core_bwd_reference)(
        q, k, v, do, H)
    for g, h, a, f in zip(got, again, apart, forced):
        assert torch.equal(g, h) and torch.equal(g, a) and torch.equal(g, f)
    if att:
        assert torch.equal(got[0], fwd)
    for g, w, e in zip(got, want, earlier):
        _assert_bf16_rule(g, w)
        _assert_bf16_rule(g, e)


@pytest.mark.cuda
def test_wide_registers_bwd_kernels_do_not_spill_on_the_card(cuda_device):
    """No wide backward instance (K8b's registers dq kernel at Dh 256-896,
    the shared dk/dv side, the core's wide dq side) takes local memory on
    the card; K8b's dk/dv kernel at each width is the core's instance."""
    flash = TF.kernel_attrs()
    wide = {k: v for k, v in flash.items() if k[0].startswith("registers d") and k[1] > 128}
    assert sorted({k[1] for k in wide}) == list(TF.WIDE_DIMS) and len(wide) == 12
    core = {k: v for k, v in TA.kernel_attrs().items()
            if k.startswith("backward registers") and "-" in k}
    assert len(core) == 12
    for dh in TF.WIDE_DIMS:
        assert flash[("registers dk dv", dh)] == core[f"backward registers {dh - 112}-{dh} dk dv"]
    for name, a in {**wide, **core}.items():
        assert a["local_bytes"] == 0 and 0 < a["registers"] <= 255, name


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,tier", [(4, 256, 384, 1, "fused"), (16, 64, 768, 1, "split"),
                                          (4, 256, 1024, 2, None), (2, 16, 3712, 1, None)])
def test_half_blocks_around_the_streamed_cores_match_plain_on_the_card(cuda_device, B, N, D, H,
                                                                      tier):
    """The half-block where the streamed cores run: DiT-S/4 --heads 1 at 64
    px (K2f, K2b), DiT-B/4 --heads 1 (K2f, K4), DiT-L/4 --heads 2 at 64 px
    (the third rung around K7) and Dh 3712 at N 16 (K7 between plain
    products): the forward by the bf16 rule, all seven gradients through
    autograd twice (bit-identical), dx by the bf16 tolerance and each fp32
    gradient within twice bf16's own noise on this step (the plain bf16
    chain against the plain fp32 one, relative Frobenius) or 1e-3: at one
    head of 768 a core output's flipped bf16 rounding, which the bf16 rule
    admits on a few per cent of entries, moves the LN gradients by ~1e-3."""
    assert TT.attention_tier(B, N, D, H) == tier
    core = None if tier else TT.core_tier(B, N, D, H)
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=32))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(33),
                       device=cuda_device).to(torch.bfloat16)
    counters = (TA.LAUNCHES, TA.BWD_LAUNCHES, TA.SPLIT_BWD_LAUNCHES, TA.CORE_LAUNCHES,
                TA.CORE_BWD_LAUNCHES)
    before = [c.count for c in counters]
    with torch.inference_mode():
        out = TA.fused_attention_block(*args, H)
    got = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    again = _grads_through_autograd(TA.fused_attention_block, args, (H,), dout)
    torch.cuda.synchronize()
    want = {"fused": [3, 2, 0, 0, 0], "split": [3, 0, 2, 0, 0], None: [0, 0, 0, 3, 2]}[tier]
    assert [c.count - n for c, n in zip(counters, before)] == want
    if tier:
        _assert_bf16_rule(out, TA.attention_block_reference(*args, H))
        wgrads = TA.attention_block_bwd_reference(*args, H, dout)
        want32 = TA.attention_block_bwd_reference(args[0].float(), *args[1:], H, dout.float())
    else:
        _assert_bf16_rule(out, TA.rung3_block_reference(*args, H, core))
        wgrads = TA.rung3_block_bwd_reference(*args, H, dout, core)
        want32 = TA.rung3_block_bwd_reference(args[0].float(), *args[1:], H, dout.float(), core)
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    torch.testing.assert_close(got[0].float(), wgrads[0].float(), **BF16_TOL)
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))  # noqa: E731
    for i, (g, w, w32) in enumerate(zip(got[1:], wgrads[1:], want32[1:]), start=1):
        assert rel(g, w) <= max(2 * rel(w, w32), GRAD_FROB_REL), i


def _ln_dense_inputs(T, D, K, seed=40):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((T, D)).astype(np.float32),
        scale=(1 + 0.1 * r.standard_normal(D)).astype(np.float32),
        bias=(0.1 * r.standard_normal(D)).astype(np.float32),
        w=(D ** -0.5 * r.standard_normal((D, K))).astype(np.float32),
        b=(0.1 * r.standard_normal(K)).astype(np.float32),
    )


# the DiT tail's (T, D, K) on the paths (DiT-S/4 training and sampling, the
# wide paths' training rows at D 768-1536, the depth-1 MoE at D 6144), then
# T off 64, K off 16 and the largest K
X4_SHAPES = [(131072, 384, 48), (16384, 384, 48), (131072, 768, 48), (131072, 1024, 48),
             (131072, 1152, 48), (131072, 1536, 48), (32768, 6144, 48), (1000, 256, 12),
             (4096, 128, 512), (300, 384, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,K", X4_SHAPES)
def test_x4_kernels_match_plain_on_the_card(cuda_device, T, D, K):
    """X4f by the bf16 rule (two units in the last place at the largest
    output, mean below 1e-3); X4b through autograd twice, bit-identical, dx
    by the bf16 rule and each fp32 gradient within 1e-2 of its largest entry
    and 1e-3 relative Frobenius (PERF.md section 2)."""
    args = _on(cuda_device, _ln_dense_inputs(T, D, K))
    dout = torch.randn(T, K, generator=torch.Generator(device=cuda_device).manual_seed(41),
                       device=cuda_device)
    before = (TLD.FWD_LAUNCHES.count, TLD.BWD_LAUNCHES.count)
    with torch.inference_mode():
        got = TLD.fused_ln_dense(*args)
    assert got.dtype == torch.float32 and got.shape == (T, K)
    _assert_bf16_rule(got, TLD.ln_dense_reference(*args))
    grads = _grads_through_autograd(TLD.fused_ln_dense, args, (), dout)
    again = _grads_through_autograd(TLD.fused_ln_dense, args, (), dout)
    torch.cuda.synchronize()
    assert (TLD.FWD_LAUNCHES.count - before[0], TLD.BWD_LAUNCHES.count - before[1]) == (3, 2)
    for g, h in zip(grads, again):  # deterministic: fixed-order partials, no atomics
        assert torch.equal(g, h)
    want = TLD.ln_dense_bwd_reference(*args[:4], dout)
    _assert_bf16_rule(grads[0], want[0])
    for i, (g, w) in enumerate(zip(grads[1:], want[1:]), start=1):
        assert g.dtype == torch.float32 and g.shape == w.shape, i
        assert float((g - w).abs().max()) <= GRAD_MAX_REL * float(w.abs().max()), i
        assert float(torch.linalg.norm(g - w)) <= GRAD_FROB_REL * float(torch.linalg.norm(w)), i


@pytest.mark.cuda
def test_x4_refuses_fp32_and_leaves_refused_shapes_plain_on_the_card(cuda_device):
    args = _on(cuda_device, _ln_dense_inputs(64, 384, 48))
    with pytest.raises(TypeError):
        TLD.fused_ln_dense(args[0].float(), *args[1:])
    plain = _on(cuda_device, _ln_dense_inputs(64, 320, 48))  # D % 128 != 0: the plain pair
    before = TLD.FWD_LAUNCHES.count
    torch.testing.assert_close(TLD.fused_ln_dense(*plain), TLD.ln_dense_reference(*plain))
    assert TLD.FWD_LAUNCHES.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H,F", [(256, 64, 384, 6, 1536), (64, 16, 384, 6, 1536),
                                       (5, 32, 384, 6, 1536), (7, 48, 256, 4, 1024),
                                       (16, 64, 128, 2, 512)])
def test_x2f_is_the_k2f_k1f_pair_bit_for_bit_on_the_card(cuda_device, B, N, D, H, F):
    """X2f's output equals bit for bit the K2f -> MLP pair composed from the
    WMMA products (``gemm.ln_gemm`` + ``gemm.gemm_residual``, which K6f
    still launches) around the resident core: the qkv product with the bias
    epilogue, the core, the projection with the residual, then the MLP
    half's two products (K2f and K1f run the wgmma products, whose sums run
    in another order): a rounded where the pair writes it, every product's
    slices in the pair's order, the pair's epilogues and the core
    tools/exp_whole_block.py reproduces; and the plain version's by the
    bf16 rule."""
    x, *attn = _on(cuda_device, _attn_inputs(B, N, D, seed=50))
    _, *mlp = _on(cuda_device, _mlp_inputs(8, D, F, seed=51))
    args = (x, *attn, *mlp)
    counters = (TA.LAUNCHES, TW.LAUNCHES)
    before = [c.count for c in counters]
    g = TM.gemm
    with torch.inference_mode():
        sa, ba, wqkv, bqkv, wproj, bproj = TA._kernel_operands(*attn)
        x2 = x.reshape(B * N, D)
        qkv, _, _ = g.ln_gemm(x2, sa, ba, wqkv, bqkv, g.EPI_BIAS)
        att = TA._k2_core(qkv.view(B, N, 3 * D), H, "resident")
        a = g.gemm_residual(att.view(B * N, D), wproj, bproj, x2)
        s, bb, w1b, b1f, w2b, b2f = TM._kernel_operands(*mlp)
        hidden, _, _ = TM.gemm.ln_gemm(a, s, bb, w1b, b1f, TM.gemm.EPI_GELU)
        want = TM.gemm.gemm_residual(hidden, w2b, b2f, a).reshape(B, N, D)
        got = TW.whole_block_fwd(*args, H)
        torch.cuda.synchronize()
    assert [c.count - n for c, n in zip(counters, before)] == [0, 1]  # K2f's chain is wgmma
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, D)
    assert torch.equal(got, want)
    _assert_bf16_rule(got, TW.whole_block_reference(*args, H))


@pytest.mark.cuda
def test_x2f_refuses_other_shapes_on_the_card(cuda_device):
    x, *attn = _on(cuda_device, _attn_inputs(2, 64, 768, seed=52))
    _, *mlp = _on(cuda_device, _mlp_inputs(8, 768, 3072, seed=53))
    with pytest.raises(NotImplementedError, match="item 14"):
        TW.whole_block_fwd(x, *attn, *mlp, 12)


@pytest.mark.cuda
def test_dit_s_training_step_through_x4_matches_plain_on_the_card(cuda_device):
    """One DiT-S/4 step (depth 8, batch 16 x m 8) through the kernels, X4f
    and X4b included, twice (bit-identical), against the plain step within
    twice bf16's own noise, as chip_smoke.py's step phases hold it."""
    import chip_smoke
    from ddm_tpu_torch.models.factory import MODEL_DEFAULTS

    cfg = {**MODEL_DEFAULTS, "depth": 8, "sample_steps": 20, "eps_churn": 1.0}
    chip_smoke.phase_train_step(
        cfg, "card test", 16, 8, "train-step-x4", "DiT-S/4",
        {"K2f": 8, "K2b": 8, "K1f": 8, "K1b": 8, "K3f": 1, "K3b": 1})


# X1 at the tool's shapes (DiT-S/4 and DiT-B/4 training), and at N 48, Dh 40
# (heads padded to 48 columns, a 16-row query tile); with the library's tiles
X1_SHAPES = [(2048, 64, 384, 6), (2048, 64, 768, 12), (64, 48, 320, 8)]
X1_PLANS = [dict(QT=32, most=4, groups=[1, 2, 3]), dict(QT=32, most=4, groups=[1, 2, 3, 4]),
            dict(QT=16, most=8, groups=[1, 2, 4, 8])]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", zip(X1_SHAPES, X1_PLANS))
def test_x1_cores_are_k2s_cores_bit_for_bit_on_the_card(cuda_device, shape, want):
    """X1f's output is the production resident forward core's, and X1b's
    att, dq, dk and dv at every group that fits are the one-block
    backward's, bit for bit; X1b's second call is bit-identical. The library's tiles: a 32-row
    query tile where it divides N, and up to 4 heads a backward group at
    N = Dh = 64 (44 KB a head), the largest dividing H by default."""
    B, N, D, H = shape
    gen = torch.Generator(device=cuda_device).manual_seed(60)
    qkv = torch.randn(B, N, 3 * D, generator=gen, device=cuda_device).to(torch.bfloat16)
    do = torch.randn(B, N, D, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    plan = TPS.library_plan(N, D, H)
    assert {k: plan[k] for k in want} == want and plan["G"] == want["groups"][-1]
    assert plan["fwd_smem"] <= 232448 and plan["bwd_smem"] <= 232448
    before = (TPS.LAUNCHES.count, TPS.BWD_LAUNCHES.count)
    with torch.no_grad():
        assert torch.equal(TPS.launch_x1f(q, k, v, H), TA._launch_core(q, k, v, H, "resident"))
        want = TA._launch_core_bwd(q, k, v, do, H, True, "one-block")
        for G in plan["groups"]:
            got = TPS.launch_x1b(q, k, v, do, H, G)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), G
        again = TPS.launch_x1b(q, k, v, do, H)
        assert all(torch.equal(g, w) for g, w in zip(again, want))
    torch.cuda.synchronize()
    assert (TPS.LAUNCHES.count - before[0], TPS.BWD_LAUNCHES.count - before[1]) == (
        1, len(plan["groups"]) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", X1_SHAPES[:2] + [(256, 64, 384, 6)])
def test_x1_half_blocks_are_k2f_and_k2b_bit_for_bit_on_the_card(cuda_device, B, N, D, H):
    """K2f's and K2b's chains around X1f and X1b give K2f's output and K2b's
    seven gradients bit for bit (the cores forced to the resident and
    one-block designs), and the plain versions' by the kernel rules."""
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=61))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(62),
                       device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        got = TPS.phase_attention_block_fwd(*args, H)
        assert torch.equal(got, TA._k2f(*args, H, "resident"))
        _assert_bf16_rule(got, TA.attention_block_reference(*args, H))
        grads = TPS.phase_attention_block_bwd(*args, H, dout)
        assert all(torch.equal(g, w) for g, w in zip(grads, TA._k2b(
            *args, H, dout, design="one-block")))
        _assert_grads_close(grads, TA.attention_block_bwd_reference(*args, H, dout))


@pytest.mark.cuda
def test_x1_refuses_other_shapes_on_the_card(cuda_device):
    args = _on(cuda_device, _attn_inputs(2, 256, 384, seed=63))
    with pytest.raises(NotImplementedError, match="item 14"):
        TPS.phase_attention_block_fwd(*args, 6)
    q = torch.zeros(2, 64, 384, dtype=torch.bfloat16, device=cuda_device)
    for G in (4, 5, 6):  # 4 and 5 do not divide 6; 6 heads do not fit a block
        with pytest.raises(RuntimeError, match=f"G={G}"):
            TPS.launch_x1b(q, q, q, q, 6, G)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [name for name, _ in TAB.VARIANTS])
@pytest.mark.parametrize("B,N,D,H", [(256, 64, 384, 6), (64, 48, 320, 8)])
def test_x3_variants_match_plain_on_the_card(cuda_device, variant, B, N, D, H):
    """Each of the tool's variants removes the phase it names and nothing
    else: the kernel chain against its plain version within twice bf16's own
    noise on that variant (the plain bf16 chain against the plain fp32 one,
    in max and Frobenius error; without the softmax or the dS algebra the
    outputs grow to ~300x the baseline's and a flipped bf16 rounding moves
    them in proportion), never tighter than the gradient rule (dbproj sums
    the bf16 cotangent, so both plain chains give it the same bits), zeros
    where the variant zeroes an output; all flags off, K2b bit for bit and
    the kernel rules."""
    skips = dict(TAB.VARIANTS)[variant]
    args = _on(cuda_device, _attn_inputs(B, N, D, seed=64))
    dout = torch.randn(B, N, D, generator=torch.Generator(device=cuda_device).manual_seed(65),
                       device=cuda_device).to(torch.bfloat16)
    before = (TAB.LAUNCHES.count, TA.BWD_LAUNCHES.count)
    with torch.no_grad():
        got = TAB.attention_block_bwd_ablate(*args, H, dout, **skips)
        again = TAB.attention_block_bwd_ablate(*args, H, dout, **skips)
        torch.cuda.synchronize()
        assert (TAB.LAUNCHES.count - before[0], TA.BWD_LAUNCHES.count - before[1]) == (2, 0)
        assert all(torch.equal(g, h) for g, h in zip(got, again))
        want = TAB.attention_block_bwd_ablate_reference(*args, H, dout, **skips)
        want32 = TAB.attention_block_bwd_ablate_reference(args[0].float(), *args[1:], H,
                                                          dout.float(), **skips)
        for i, (g, w, w32) in enumerate(zip(got, want, want32)):
            g, w, w32 = g.float(), w.float(), w32.float()
            if not w32.any():
                assert not g.any(), i
                continue
            top, frob = float(w.abs().max()), float(torch.linalg.norm(w))
            assert float((g - w).abs().max()) <= max(2 * float((w - w32).abs().max()),
                                                     GRAD_MAX_REL * top), i
            assert float(torch.linalg.norm(g - w)) <= max(2 * float(torch.linalg.norm(w - w32)),
                                                          GRAD_FROB_REL * frob), i
        if not skips:  # K2b's chain on its one-block core (at D 320 the ladder has no tier)
            _assert_grads_close(got, want)
            assert all(torch.equal(g, w) for g, w in zip(got, TA._k2b(*args, H, dout,
                                                                      design="one-block")))


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F", [(131072, 384, 1536), (1000, 128, 512)])
def test_x3_identity_gelu_k1f_matches_plain_on_the_card(cuda_device, T, D, F):
    args = _on(cuda_device, _mlp_inputs(T, D, F, seed=66))
    before = (TAB.MLP_LAUNCHES.count, TM.LAUNCHES.count)
    with torch.inference_mode():
        got = TAB.mlp_block_fwd_identity_gelu(*args)
        torch.cuda.synchronize()
        _assert_bf16_rule(got, TAB.mlp_block_identity_gelu_reference(*args))
        assert not torch.equal(got, TM.fused_mlp_block(*args))  # the GELU is gone
    assert (TAB.MLP_LAUNCHES.count - before[0], TM.LAUNCHES.count - before[1]) == (1, 1)


@pytest.mark.cuda
def test_x3_refuses_other_shapes_on_the_card(cuda_device):
    args = _on(cuda_device, _attn_inputs(2, 128, 384, seed=67))
    with pytest.raises(NotImplementedError, match="item 14"):
        TAB.attention_block_bwd_ablate(*args, 6, args[0], skip_dw=True)
