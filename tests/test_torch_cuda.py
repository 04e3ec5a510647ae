"""The CUDA kernels K1 and K2 against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a GPU. The
file imports no JAX (the machine with the card has none), so it runs there
without the JAX test harness:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402

# bf16 outputs: the kernel and the plain version round at the same points,
# but fp32 sums taken in another order can flip a rounding, which moves an
# output by one bf16 unit: 2^-6 at |out| < 4, 2^-5 below 8.
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)


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


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,F", [(16384, 384, 1536), (1000, 128, 512)])
def test_k1_kernel_matches_plain_on_the_card(cuda_device, T, D, F):
    a = {k: _t(v).to(cuda_device) for k, v in _mlp_inputs(T, D, F).items()}
    args = (a["x"].to(torch.bfloat16), a["scale"], a["bias"], a["w1"],
            a["b1"], a["w2"], a["b2"])
    before = TM.LAUNCHES.count
    with torch.inference_mode():
        got = TM.fused_mlp_block(*args)
        torch.cuda.synchronize()
        want = TM.mlp_block_reference(*args)
    assert TM.LAUNCHES.count == before + 1
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,H", [(256, 64, 384, 6), (5, 128, 256, 4), (3, 16, 128, 2)])
def test_k2_kernel_matches_plain_on_the_card(cuda_device, B, N, D, H):
    a = {k: _t(v).to(cuda_device) for k, v in _attn_inputs(B, N, D).items()}
    args = (a["x"].to(torch.bfloat16), a["scale"], a["bias"], a["wqkv"],
            a["bqkv"], a["wproj"], a["bproj"])
    before = TA.LAUNCHES.count
    with torch.inference_mode():
        got = TA.fused_attention_block(*args, H)
        torch.cuda.synchronize()
        want = TA.attention_block_reference(*args, H)
    assert TA.LAUNCHES.count == before + 1
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros(64, 128, device=cuda_device)
    vec, w = torch.zeros(128, device=cuda_device), torch.zeros(512, 128, device=cuda_device)
    b1, w2 = torch.zeros(512, device=cuda_device), torch.zeros(128, 512, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        TM.fused_mlp_block(x, vec, vec, w, b1, w2, vec)
    with pytest.raises(NotImplementedError, match="backward"):
        TM.fused_mlp_block(x.bfloat16().requires_grad_(), vec, vec, w, b1, w2, vec)
