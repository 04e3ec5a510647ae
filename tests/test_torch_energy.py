"""Parity of the port's energy score (kernel K3's Function, its plain versions)
and loss terms with the JAX package's.

The JAX side runs its fused energy kernel in Pallas interpret mode, with its
plain ``generalized_energy_terms`` made to raise so that the kernel path is
proven taken; the port's side runs the plain versions on CPU tensors (its
CUDA kernels are held to them on the card by ``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.energy as JE  # noqa: E402
import ddm_tpu.ops.losses as JL  # noqa: E402
from ddm_tpu_torch.ops import energy as TE  # noqa: E402
from ddm_tpu_torch.ops import losses as TL  # noqa: E402

# fp32 sums over D and the pairs taken in another order
VALUE_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL = 1e-4  # of the gradient's largest entry
GCONF, GINTER = 0.7, -0.3


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain energy terms, not the Pallas kernel")

    monkeypatch.setattr(JE, "_jnp_energy_terms", boom)


def _inputs(B, m, D, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, m, D)).astype(np.float32),
            r.standard_normal((B, D)).astype(np.float32))


def _port(xh, x0, beta, fn=TE.fused_energy_terms):
    leaves = [torch.from_numpy(xh).requires_grad_(), torch.from_numpy(x0).requires_grad_()]
    conf, inter = fn(*leaves, beta)
    torch.autograd.backward((conf, inter), (torch.tensor(GCONF), torch.tensor(GINTER)))
    return (float(conf.detach()), float(inter.detach()), leaves[0].grad.numpy(),
            leaves[1].grad.numpy())


def _jax(xh, x0, beta, fn):
    (conf, inter), vjp = jax.vjp(lambda a, b: fn(a, b, beta), jnp.asarray(xh), jnp.asarray(x0))
    gxh, gx0 = vjp((jnp.float32(GCONF), jnp.float32(GINTER)))
    return float(conf), float(inter), np.asarray(gxh), np.asarray(gx0)


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], **VALUE_TOL)
    np.testing.assert_allclose(got[1], want[1], **VALUE_TOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max())


@pytest.mark.parametrize("beta", [0.1, 2.0])
def test_energy_terms_and_grads_match_jax_kernel(jax_kernels_only, beta):
    B, m, D = 8, 4, 256
    assert JE._kernel_supported(B, m, D)  # the JAX side takes its K3 kernel here
    xh, x0 = _inputs(B, m, D)
    _assert_match(_port(xh, x0, beta), _jax(xh, x0, beta, JE.fused_energy_terms))


@pytest.mark.parametrize("beta", [0.1, 2.0])
@pytest.mark.parametrize("chunked", [False, True])
def test_losses_energy_terms_match_jax(monkeypatch, beta, chunked):
    """The plain losses (direct differences, and the anchor-row walk past
    2^28 pair elements) against ``ddm_tpu.ops.losses``, values and grads."""
    if chunked:  # force the large-m path at a small size on both sides
        monkeypatch.setattr(JL, "_DIRECT_PAIR_ELEMS", 0)
        monkeypatch.setattr(TL, "DIRECT_PAIR_ELEMS", 0)
    xh, x0 = _inputs(3, 5, 48, seed=1)

    def port_losses(a, b, beta_):
        return TL.generalized_energy_terms(a, b, beta_)

    _assert_match(_port(xh, x0, beta, port_losses),
                  _jax(xh, x0, beta, JL.generalized_energy_terms))


def test_energy_plain_backward_is_the_autograd_of_the_plain_forward():
    xh, x0 = _inputs(4, 3, 32, seed=2)
    for beta in (0.1, 1.0, 2.0):
        want = _port(xh, x0, beta, lambda a, b, be: TE.energy_terms_reference(a, b, be))
        got = _port(xh, x0, beta)
        _assert_match(got, want)


def test_pairwise_sqdist_and_sigmoid_weight_match_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(TL.pairwise_sqdist(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.pairwise_sqdist(jnp.asarray(x))), rtol=1e-6)
    t = np.concatenate([[0.0, 1.0], r.uniform(0, 1, 9)]).astype(np.float32)
    for bias in (0.0, 1.5):
        np.testing.assert_allclose(TL.sigmoid_weight(torch.from_numpy(t), bias).numpy(),
                                   np.asarray(JL.sigmoid_weight(jnp.asarray(t), bias)),
                                   rtol=1e-6, atol=1e-7)


def test_energy_counts_no_launch_on_cpu_and_takes_any_m():
    TE.FWD_LAUNCHES.reset()
    TE.BWD_LAUNCHES.reset()
    xh, x0 = _inputs(2, 17, 16, seed=4)  # m > 16: the plain version on the CPU
    conf, inter, gxh, gx0 = _port(xh, x0, 0.1)
    assert np.isfinite([conf, inter]).all() and np.isfinite(gxh).all()
    assert TE.FWD_LAUNCHES.count == 0 and TE.BWD_LAUNCHES.count == 0
