"""Parity of the port's split attention backward (K4's plain chain) with the
JAX package's ``_fused_block_sb``, whose forward (K2f) and split backward
(``_blk_bwd_split_kernel``) run as Pallas kernels in interpret mode.

The port's half-block runs on CPU tensors with the ``split`` tier forced, so
its backward is :func:`attention_block_bwd_reference` around
:func:`attention_core_bwd_att_reference`, the oracle that the CUDA chain of
K4 is held to on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402

# N = 64 tokens as at 32 px, Dh = 64: the JAX split kernel packs g = 4
# images into one 256-wide product here, as it does at DiT-B
B, N, D, H = 4, 64, 128, 2
NAMES = ["x", "scale", "bias", "wqkv", "bqkv", "wproj", "bproj"]
# fp32: sums of B*N rows taken in another order, 1e-4 relative with the
# absolute part scaled by each gradient's largest entry
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both sides round at the same points, but a flipped rounding of one
# bf16 intermediate (qkv, P, dS, datt) moves single entries by a bf16 unit
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)


def _inputs(seed=3):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((B, N, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, 3 * D)), 0.1 * r.standard_normal(3 * D),
        D ** -0.5 * r.standard_normal((D, D)), 0.1 * r.standard_normal(D),
        r.standard_normal((B, N, D)))]


@pytest.fixture(scope="module")
def jax_split():
    """``_fused_block_sb``'s output and seven gradients in fp32 and bf16."""
    *args, dout = _inputs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        g = JA._attn_pack(B, N, D, H)
        assert g == 4 and JA._bwd_split_block_images(B, N, D, g, H) >= g
        for name in ("float32", "bfloat16"):
            dt = getattr(jnp, name)
            y, vjp = jax.vjp(lambda *a: JA._fused_block_sb(*a, H),
                             jnp.asarray(args[0], dt), *(jnp.asarray(a) for a in args[1:]))
            grads = vjp(jnp.asarray(dout, dt))
            out[name] = (np.asarray(y.astype(jnp.float32)),
                         [np.asarray(v.astype(jnp.float32)) for v in grads])
    return out


def _port(dtype, monkeypatch):
    """The port's half-block with the split tier, through autograd."""
    monkeypatch.setattr(tiers, "attention_tier", lambda *a: "split")
    *args, dout = [torch.from_numpy(a) for a in _inputs()]
    # nn.Linear's (out, in) layout: JAX's (in, out) transposed
    leaves = [args[0].to(dtype)] + [a.t().contiguous() if a.dim() == 2 else a for a in args[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    out = TA.fused_attention_block(*leaves, H)
    out.backward(dout.to(dtype))
    grads = [(a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
             for i, a in enumerate(leaves)]
    return out.detach().float().numpy(), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_backward_matches_jax(jax_split, monkeypatch, dtype):
    want_out, want = jax_split[dtype]
    TA.SPLIT_BWD_LAUNCHES.reset()
    got_out, got = _port(getattr(torch, dtype), monkeypatch)
    assert TA.SPLIT_BWD_LAUNCHES.count == 0  # CPU tensors: the plain chain
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got_out, want_out, rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, float(np.abs(want_out).max())))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"gradient of {name}")


def test_split_and_fused_jax_backwards_agree_with_one_plain_version(jax_split, monkeypatch):
    """K2b and K4 share one rounding plan, so one plain version serves both:
    JAX's fused backward on the same inputs lies within fp32 noise of its
    split one, and both of the port's plain chain."""
    *args, dout = _inputs()
    with monkeypatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        g = JA._attn_pack(B, N, D, H)
        assert JA._bwd_block_images(B, N, D, g, H) >= g
        _, vjp = jax.vjp(lambda *a: JA._fused_block(*a, H), *(jnp.asarray(a) for a in args))
        fused = [np.asarray(v) for v in vjp(jnp.asarray(dout))]
    for name, f, s in zip(NAMES, fused, jax_split["float32"][1]):
        np.testing.assert_allclose(f, s, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(s).max())),
                                   err_msg=name)


def test_core_writes_the_forward_cores_output():
    """The plain K2b/K4 core's att is bit for bit the plain forward core's, and
    its dq, dk, dv are the fp32 gradients of that core rounded once."""
    r = np.random.default_rng(5)
    q, k, v, datt = (torch.from_numpy(r.standard_normal((3, 16, 128)).astype(np.float32))
                     for _ in range(4))
    att, dq, dk, dv = TA.attention_core_bwd_att_reference(q, k, v, datt, 2)
    assert torch.equal(att, TA.attention_reference(q, k, v, 2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(TA.attention_reference(*leaves, 2), leaves, datt)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
