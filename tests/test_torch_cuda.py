"""The CUDA kernels K1-K4, K6f, K6b, K7-K9 and K10-K12 against their plain versions, on the
card, at head widths off 16 (Dh 8, 24, 40, 72), at DiT-XL's D 1152, and with the fast GELU.

Every test here is marked ``cuda`` and skips on a host without a GPU. The
file imports no JAX (the machine with the card has none), so it runs there
without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import energy as TE  # noqa: E402
from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402
from ddm_tpu_torch.ops import flash as TF  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import moe_dispatch as TD  # noqa: E402
from ddm_tpu_torch.ops import tiers as TT  # noqa: E402

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
    P: bit for bit the forward core's output on the same qkv."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    qkv = torch.randn(B, N, 3 * H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    datt = torch.randn(B, N, H * Dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    att, dqkv = TA._core_bwd_att(qkv, datt, H)
    assert torch.equal(att, TA._k2_core(qkv, H))
    want = TA.attention_core_bwd_att_reference(*qkv.split(H * Dh, dim=-1), datt, H)
    _assert_bf16_rule(att, want[0])
    _assert_bf16_rule(dqkv, torch.cat(want[1:], dim=-1))


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
    with pytest.raises(NotImplementedError, match="N=24.*Queue 2"):  # the JAX gate takes N % 8
        TA.fused_attention_block(tokens, vec, vec, wqkv, bqkv, wproj, vec, 2)
    q = torch.zeros(2, 24, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="Queue 2"):
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
    K2b run on the same qkv (one design behind two entry points)."""
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
    assert torch.equal(torch.cat(grads, dim=-1), dqkv) and torch.equal(att, o)


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


@pytest.mark.cuda
@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("T,D,E,gs,n_valid", [(131072, 384, 8, 256, 131072),
                                              (512, 128, 4, 64, 450),
                                              (32768, 1152, 8, 256, 32768),
                                              (32768, 1152, 16, 256, 32700),
                                              (16384, 2048, 8, 256, 16384),
                                              (8192, 384, 64, 256, 8192)])
def test_k11_k12_kernels_match_plain_on_the_card(cuda_device, topk, T, D, E, gs, n_valid):
    """Dispatch and combine, forward and backward, against their plain
    versions; the second case pads 62 rows that take no route, the next ones
    are DiT-XL/4's width with 8 and 16 experts (68 padded rows), D 2048 (the
    backward's column tiles) and 64 experts (two a lane). The kernel's
    LN statistics differ from the plain version's in the last fp32 bits,
    which can flip the bf16 rounding of an LN output entry and so move a
    logit by one bf16 unit of the largest |yb| times max |wr|: a token may
    route otherwise only within twice that of a tie, the gates and router
    probabilities agree to it, and groups whose routing differs are left
    out of the slot-row comparison."""
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
    assert float((gates[agree] - want[1][agree]).abs().max()) <= tol
    assert float((probs - want[4]).abs().max()) <= tol
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
    # past the kernels' bounds, where the JAX gate still takes them: Queue 2
    x, scale, bias, wr, br = _moe_inputs(cuda_device, 256, 128, 72)
    cfg, _ = TD.moe_cfg(256, 72, 256, 1.25, 1)
    with pytest.raises(NotImplementedError, match="E=72.*Queue 2"):
        TD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br)
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


@pytest.mark.cuda
@pytest.mark.parametrize("E,S,D,F,forced", [(8, 20480, 768, 3072, False), (4, 200, 128, 512, True)])
def test_k10p_matches_plain_on_the_card(cuda_device, monkeypatch, E, S, D, F, forced):
    """The expert FFN's F-chunked forward (k = 2 K10p) by the bf16 rule, one
    chunk's fp32 partial by the partial rule, and the five
    gradients of K10b's chain through autograd, twice, bit-identical."""
    if forced:
        monkeypatch.setattr(TT, "expert_tier", lambda *a: ("fwdonly", 2))
    assert TT.expert_tier(E, S, D, F) == ("fwdonly", 2)
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
        out = TX.expert_ffn(*args)
    _assert_bf16_rule(out, TX.expert_ffn_fchunked_reference(*args, 2))
    fc = F // 2
    chunk = (args[0], args[1].to(torch.bfloat16)[:, :, fc:], args[2][:, fc:],
             args[3].to(torch.bfloat16)[:, fc:])
    acc = torch.empty(E, S, D, device=cuda_device)
    TX._k10p(*chunk, TX.gemm.NN_F32, acc)
    _assert_partial_rule(acc, TX.expert_partial_reference, chunk, lambda a, pd, pf: (
        a[0][:, :, pd].contiguous(), a[1][:, pd][:, :, pf], a[2][:, pf], a[3][:, pf][:, :, pd]))
    got = _grads_through_autograd(TX.expert_ffn, args, (), dout)
    again = _grads_through_autograd(TX.expert_ffn, args, (), dout)
    torch.cuda.synchronize()
    after = (TX.PARTIAL_LAUNCHES.count, TX.LAUNCHES.count, TX.BWD_LAUNCHES.count)
    assert tuple(a - b for a, b in zip(after, before)) == (2 + 1 + 2 * 2, 0, 2)
    _assert_grads_close(got, TX.expert_ffn_bwd_reference(*args, dout))
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
    tiled, single = TA._core_bwd_att(qkv, datt, H, tiled=True), TA._core_bwd_att(
        qkv, datt, H, tiled=False)
    assert torch.equal(tiled[0], single[0]) and torch.equal(tiled[1], single[1])
    want = TA.attention_core_bwd_att_reference(*qkv.split(H * Dh, dim=-1), datt, H)
    _assert_bf16_rule(tiled[1], torch.cat(want[1:], dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F", [(16384, 384, 768), (1000, 128, 256)])
def test_k6b_tp_partial_matches_plain_on_the_card(cuda_device, T, D, F):
    """The tensor-parallel MLP partial through autograd: one K6f forward (fp32,
    by the partial rule) and K6b backward for an fp32 cotangent, against
    :func:`mlp_partial_bwd_reference` (dx by the bf16 rule, the fp32
    gradients by the gradient rule), twice, bit-identical; and K6b called
    directly gives the same bits."""
    inputs = _mlp_inputs(T, D, F, seed=31)
    del inputs["b2"]
    args = _on(cuda_device, inputs)
    do = torch.randn(T, D, generator=torch.Generator(device=cuda_device).manual_seed(32),
                     device=cuda_device)
    assert TT.mlp_tier(T, D, F)[0] in ("fused", "fwdonly")
    before = (TM.PARTIAL_LAUNCHES.count, TM.PARTIAL_BWD_LAUNCHES.count, TM.BWD_LAUNCHES.count)
    with torch.inference_mode():
        part = TM.fused_mlp_partial(*args)
    got = _grads_through_autograd(TM.fused_mlp_partial, args, (), do)
    again = _grads_through_autograd(TM.fused_mlp_partial, args, (), do)
    direct = TM.mlp_partial_bwd(*args, do)
    torch.cuda.synchronize()
    assert (TM.PARTIAL_LAUNCHES.count - before[0], TM.PARTIAL_BWD_LAUNCHES.count - before[1],
            TM.BWD_LAUNCHES.count - before[2]) == (3, 3, 0)
    assert part.dtype == torch.float32
    _assert_partial_rule(part, TM.mlp_partial_reference, args, lambda a, pd, pf: (
        a[0][:, pd].contiguous(), a[1][pd], a[2][pd], a[3][pf][:, pd], a[4][pf], a[5][pd][:, pf]))
    _assert_grads_close(got, TM.mlp_partial_bwd_reference(*args, do))
    for g, h, d in zip(got, again, direct):
        assert torch.equal(g, h) and torch.equal(g, d.to(g.dtype))


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
    the MLP half-block, whose F-chunked tier JAX runs as a kernel, raises
    NotImplementedError naming Queue 2 before any launch."""
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
    with pytest.raises(NotImplementedError, match="D=1536.*Queue 2"):
        TM.fused_mlp_block(*mlp)
    assert [c.count for c in (TM.LAUNCHES, TM.PARTIAL_LAUNCHES)] == before


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
