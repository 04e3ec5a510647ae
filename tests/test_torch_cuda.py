"""The CUDA kernels K1, K2 and K3 against their plain versions, on the card.

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
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402

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
@pytest.mark.parametrize("B,N,D,H", [(256, 64, 384, 6), (5, 128, 256, 4), (3, 16, 128, 2)])
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
@pytest.mark.parametrize("B,N,D,H", [(256, 64, 384, 6), (3, 16, 128, 2)])
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
@pytest.mark.parametrize("B,m,D", [(256, 8, 3072), (5, 3, 128)])
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
    with pytest.raises(ValueError, match="N=24"):
        TA.fused_attention_block(tokens, vec, vec, wqkv, bqkv, wproj, vec, 2)
    xh, x0 = torch.zeros(4, 17, 128, device=cuda_device), torch.zeros(4, 128, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K9"):
        TE.fused_energy_terms(xh, x0, 0.1)
