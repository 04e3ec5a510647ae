"""Parity of the PyTorch port's ops with the JAX package's.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode, with the JAX ``*_reference`` made to raise so that the
kernel path is proven taken) and through the port's function on CPU
tensors, which runs the port's plain version. The kernels themselves are
held to the plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
import ddm_tpu.ops.schedules as JS  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import gemm  # noqa: E402
from ddm_tpu_torch.ops import kernel_config  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import schedules as TS  # noqa: E402

# the JAX kernel tests' own tolerance (tests/test_attention.py)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both sides round at the same points, but fp32 sums taken in another
# order (and the TPU kernel's polynomial erf) can flip a rounding, which
# moves an output by one bf16 unit: 2^-6 at |out| < 4, 2^-5 below 8.
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    """Pallas in interpret mode; the JAX plain versions raise if reached."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain version, not the Pallas kernel")

    monkeypatch.setattr(JM, "mlp_block_reference", boom)
    monkeypatch.setattr(JA, "attention_block_reference", boom)


def _mlp_inputs(T=64, D=128, F=512, seed=0):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((T, D)).astype(np.float32),
        scale=(1 + 0.1 * r.standard_normal(D)).astype(np.float32),
        bias=(0.1 * r.standard_normal(D)).astype(np.float32),
        w1=(D ** -0.5 * r.standard_normal((D, F))).astype(np.float32),  # JAX (in, out)
        b1=(0.1 * r.standard_normal(F)).astype(np.float32),
        w2=(F ** -0.5 * r.standard_normal((F, D))).astype(np.float32),
        b2=(0.1 * r.standard_normal(D)).astype(np.float32),
    )


def _attn_inputs(B=8, N=16, D=128, seed=1):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((B, N, D)).astype(np.float32),
        scale=(1 + 0.1 * r.standard_normal(D)).astype(np.float32),
        bias=(0.1 * r.standard_normal(D)).astype(np.float32),
        wqkv=(D ** -0.5 * r.standard_normal((D, 3 * D))).astype(np.float32),
        bqkv=(0.1 * r.standard_normal(3 * D)).astype(np.float32),
        wproj=(D ** -0.5 * r.standard_normal((D, D))).astype(np.float32),
        bproj=(0.1 * r.standard_normal(D)).astype(np.float32),
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlp_jax(a, dtype):
    return np.asarray(JM.fused_mlp_block(
        jnp.asarray(a["x"], dtype), a["scale"], a["bias"], a["w1"], a["b1"], a["w2"],
        a["b2"]).astype(jnp.float32))


def _mlp_torch(a, dtype, fn=TM.fused_mlp_block):
    return fn(_t(a["x"]).to(dtype), _t(a["scale"]), _t(a["bias"]), _t(a["w1"].T),
              _t(a["b1"]), _t(a["w2"].T), _t(a["b2"])).float().numpy()


def _attn_jax(a, dtype, H):
    return np.asarray(JA.fused_attention_block(
        jnp.asarray(a["x"], dtype), a["scale"], a["bias"], a["wqkv"], a["bqkv"],
        a["wproj"], a["bproj"], H).astype(jnp.float32))


def _attn_torch(a, dtype, H, fn=TA.fused_attention_block):
    return fn(_t(a["x"]).to(dtype), _t(a["scale"]), _t(a["bias"]), _t(a["wqkv"].T),
              _t(a["bqkv"]), _t(a["wproj"].T), _t(a["bproj"]), H).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_half_block_matches_jax_kernel(jax_kernels_only, dtype):
    a = _mlp_inputs()
    want = _mlp_jax(a, getattr(jnp, dtype))
    got = _mlp_torch(a, getattr(torch, dtype))
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_half_block_matches_jax_kernel(jax_kernels_only, dtype):
    a = _attn_inputs()
    want = _attn_jax(a, getattr(jnp, dtype), H=2)
    got = _attn_torch(a, getattr(torch, dtype), H=2)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_attention_core_matches_jax_reference():
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal((4, 16, 64)).astype(np.float32) for _ in range(3))
    want = np.asarray(JA.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4))
    got = TA.attention_reference(_t(q), _t(k), _t(v), 4).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    TM.LAUNCHES.reset()
    TA.LAUNCHES.reset()
    a = _mlp_inputs(T=16)
    np.testing.assert_array_equal(
        _mlp_torch(a, torch.bfloat16), _mlp_torch(a, torch.bfloat16, TM.mlp_block_reference))
    b = _attn_inputs(B=2)
    np.testing.assert_array_equal(
        _attn_torch(b, torch.bfloat16, 2),
        _attn_torch(b, torch.bfloat16, 2, TA.attention_block_reference))
    assert TM.LAUNCHES.count == 0 and TA.LAUNCHES.count == 0


def test_other_devices_raise_instead_of_falling_back():
    cpu = torch.zeros(2)
    meta = torch.zeros(2, device="meta")
    assert kernel_config.uses_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        kernel_config.uses_kernel(cpu, meta)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        TM.fused_mlp_block(*(torch.zeros(4, 4, device="meta") for _ in range(7)))


def test_attention_token_gate():
    assert TA.supported_tokens(64, 64)
    assert TA.supported_tokens(128, 64)
    assert TA.supported_tokens(256, 64) and TA.supported_tokens(512, 64)  # query-tile core
    assert not TA.supported_tokens(528, 64)  # N > 512: the flash tier (K8) from N = 1024
    assert not TA.supported_tokens(24, 64)   # not a multiple of 16
    assert not TA.supported_tokens(64, 68)   # Dh not a multiple of 8
    # forward and backward at every N up to 512, whatever the head width: the
    # streamed cores take the heads whose tiles pass shared memory (which
    # design runs is the library's plan, checked on the card)
    for N in (16, 64, 112, 128, 144, 256, 400, 512):
        for Dh in (8, 64, 72, 384, 768, 1024, 3712):
            assert TA.supported_tokens(N, Dh), (N, Dh)


@pytest.mark.parametrize("T,Ma,Nb", [(131072, 1536, 384), (131072, 384, 384), (1000, 128, 512),
                                     (64, 384, 1152)])
def test_split_k_plan_covers_every_row_once(T, Ma, Nb):
    splits, rows = gemm.tn_splits(T, Ma, Nb, sms=132)
    assert rows % 64 == 0 and splits * rows >= T > (splits - 1) * rows
    assert gemm.tn_splits(T, Ma, Nb, sms=132) == (splits, rows)  # a fixed sum order


@pytest.mark.parametrize("eps_churn", [0.0, 0.5, 1.0])
def test_schedules_match_jax(eps_churn):
    r = np.random.default_rng(3)
    x0 = r.standard_normal((5, 4, 4, 3)).astype(np.float32)
    xt = r.standard_normal((5, 4, 4, 3)).astype(np.float32)
    t = r.uniform(0, 1, 5).astype(np.float32)
    for s_, t_ in [(0.0, 0.05), (0.45, 0.5), (0.95, 1.0)]:
        mu_j, std_j = JS.gaussian_bridge_mu_sigma(s_, t_, x0, xt, eps_churn=eps_churn)
        mu_t, std_t = TS.gaussian_bridge_mu_sigma(s_, t_, _t(x0), _t(xt), eps_churn=eps_churn)
        np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        TS.forward_marginal_sample(_t(x0), _t(t), _t(xt)).numpy(),
        np.asarray(JS.forward_marginal_sample(x0, t, xt)), rtol=1e-6, atol=1e-6)
    a_t, s_t = TS.alpha_sigma(_t(t))
    a_j, s_j = JS.alpha_sigma(t)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
