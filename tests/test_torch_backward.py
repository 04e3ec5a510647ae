"""Parity of the port's half-block backwards (kernels K1b and K2b, through
their ``torch.autograd.Function``s) with the JAX package's.

The same numpy inputs and cotangent go through ``jax.grad`` of the JAX
half-block, whose Pallas forward and backward kernels run in interpret mode
(the JAX plain versions and the other tiers raise if reached), and through
``backward()`` of the port's half-block on CPU tensors, which runs the
port's plain backward versions. The CUDA kernels are held to those plain
versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402

MLP_SHAPE = dict(T=128, D=128, F=512)
ATTN_SHAPE = dict(B=8, N=64, D=384, H=6)  # the shape tests/test_attention.py takes K2b at
# fp32: the kernel tests' 1e-4 / 1e-5, with the absolute part scaled by the
# gradient's largest entry (as tests/test_attention.py scales its grads):
# a weight gradient sums T products, so its near-zero entries carry the
# rounding noise of its large ones
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both sides round at the same points, but a flipped rounding of one
# bf16 intermediate (g, dh, qkv, P, dS) moves single gradient entries by a
# bf16 unit of one term; the TPU kernel's polynomial erf flips a few more.
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)
NAMES = ["x", "scale", "bias", "w_in", "b_in", "w_out", "b_out"]


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    """Pallas in interpret mode; every JAX path but the fused kernels raises."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX left its fused half-block kernel")

    for mod, name in ((JM, "mlp_block_reference"), (JM, "_fused_fwdonly"),
                      (JA, "attention_block_reference"), (JA, "_fused_block_sb")):
        monkeypatch.setattr(mod, name, boom)


def test_shapes_reach_the_jax_backward_kernels(jax_kernels_only):
    assert JM._mlp_kernel_ok(MLP_SHAPE["T"], MLP_SHAPE["D"], MLP_SHAPE["F"])
    B, N, D, H = ATTN_SHAPE.values()
    g = JA._attn_pack(B, N, D, H)
    assert g >= 1 and JA._bwd_block_images(B, N, D, g, H) >= g


def _mlp_inputs(T, D, F, seed=0):
    r = np.random.default_rng(seed)
    return [r.standard_normal((T, D)), 1 + 0.1 * r.standard_normal(D),
            0.1 * r.standard_normal(D), D ** -0.5 * r.standard_normal((D, F)),
            0.1 * r.standard_normal(F), F ** -0.5 * r.standard_normal((F, D)),
            0.1 * r.standard_normal(D), r.standard_normal((T, D))]


def _attn_inputs(B, N, D, H, seed=1):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, N, D)), 1 + 0.1 * r.standard_normal(D),
            0.1 * r.standard_normal(D), D ** -0.5 * r.standard_normal((D, 3 * D)),
            0.1 * r.standard_normal(3 * D), D ** -0.5 * r.standard_normal((D, D)),
            0.1 * r.standard_normal(D), r.standard_normal((B, N, D))]


def _jax_grads(fn, arrays, dtype, extra=()):
    *args, dout = [np.asarray(a, np.float32) for a in arrays]
    x = jnp.asarray(args[0], dtype)

    def f(x_, *w):
        return jnp.vdot(fn(x_, *w, *extra).astype(jnp.float32), dout)

    grads = jax.grad(f, argnums=tuple(range(7)))(x, *args[1:])
    return [np.asarray(g, np.float32) for g in grads]


def _port_grads(fn, arrays, dtype, extra=()):
    *args, dout = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    # the port's weights are nn.Linear's (out, in): transpose JAX's (in, out)
    leaves = [args[0].to(dtype)] + [a.t().contiguous() if a.dim() == 2 else a for a in args[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    fn(*leaves, *extra).float().backward(dout)
    return [(a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
            for i, a in enumerate(leaves)]


def _compare(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        atol = tol["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=tol["rtol"], atol=atol,
                                   err_msg=f"gradient of {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_grads_match_jax_kernel(jax_kernels_only, dtype):
    arrays = _mlp_inputs(**MLP_SHAPE)
    want = _jax_grads(JM.fused_mlp_block, arrays, getattr(jnp, dtype))
    TM.BWD_LAUNCHES.reset()
    got = _port_grads(TM.fused_mlp_block, arrays, getattr(torch, dtype))
    assert TM.BWD_LAUNCHES.count == 0  # CPU tensors: the plain backward
    _compare(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_grads_match_jax_kernel(jax_kernels_only, dtype):
    B, N, D, H = ATTN_SHAPE.values()
    arrays = _attn_inputs(B, N, D, H)
    want = _jax_grads(JA.fused_attention_block, arrays, getattr(jnp, dtype), (H,))
    TA.BWD_LAUNCHES.reset()
    got = _port_grads(TA.fused_attention_block, arrays, getattr(torch, dtype), (H,))
    assert TA.BWD_LAUNCHES.count == 0
    _compare(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("which", ["mlp", "attention"])
def test_plain_backward_is_the_autograd_of_the_plain_forward(which):
    """In fp32 the explicit plain backward equals autograd through the
    plain forward (the bf16 roundings are where the two would differ)."""
    if which == "mlp":
        arrays, fwd, bwd, extra = _mlp_inputs(32, 64, 256, seed=5), \
            TM.mlp_block_reference, TM.mlp_block_bwd_reference, ()
    else:
        arrays, fwd, bwd, extra = _attn_inputs(2, 16, 64, 2, seed=6), \
            TA.attention_block_reference, TA.attention_block_bwd_reference, (2,)
    *args, dout = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    args = [a.t().contiguous() if a.dim() == 2 and i else a for i, a in enumerate(args)]
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(fwd(*leaves, *extra), leaves, dout)
    got = bwd(*args, *extra, dout)
    for name, g, w in zip(NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
