"""Parity of the port's expert FFN (K10's plain versions) with the JAX
package's ``expert_ffn`` Pallas kernel, run in interpret mode: the forward
and all five gradients on the same numpy inputs, empty (all-zero) slot rows
included, as the dispatch leaves them; the gradients also at a slot count
the JAX gate admits that is not a multiple of 128 (S 192, its 64-row block),
where the card's 128-row tiles clip at each expert's last slot row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.expert_ffn as JX  # noqa: E402
from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402

E, S, D, F = 4, 128, 128, 256


def _bf16_ulp(want) -> float:
    """One bf16 unit in the last place at the largest magnitude of ``want``."""
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def _inputs(seed=0, E=E, S=S, D=D, F=F):
    r = np.random.default_rng(seed)
    x = r.standard_normal((E, S, D)).astype(np.float32)
    x[:, S - 24:] = 0.0  # empty slot rows (unfilled capacity)
    x[1, :40] = 0.0
    return dict(
        x=x,
        w1=((E * D) ** -0.5 * r.standard_normal((E, D, F))).astype(np.float32),
        b1=(0.1 * r.standard_normal((E, F))).astype(np.float32),
        w2=((E * F) ** -0.5 * r.standard_normal((E, F, D))).astype(np.float32),
        b2=(0.1 * r.standard_normal((E, D))).astype(np.float32),
        dout=r.standard_normal((E, S, D)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's K10 forward and its VJP on fp32 and on bf16 slot rows, in
    interpret mode."""
    a = _inputs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        for name in ("float32", "bfloat16"):
            dt = getattr(jnp, name)
            y, vjp = jax.vjp(JX.expert_ffn, jnp.asarray(a["x"], dt),
                             *(jnp.asarray(a[k]) for k in ("w1", "b1", "w2", "b2")))
            grads = vjp(jnp.asarray(a["dout"], dt))
            out[name] = (np.asarray(y.astype(jnp.float32)),
                         [np.asarray(g.astype(jnp.float32)) for g in grads])
    return a, out


def _port_args(a, dtype):
    x = torch.from_numpy(a["x"]).to(dtype)
    return (x,) + tuple(torch.from_numpy(a[k]) for k in ("w1", "b1", "w2", "b2"))


def _close(got, want, dtype, name):
    """fp32: 1e-4 relative (fp32 sums of S rows taken in another order).
    bf16: one bf16 unit at the largest entry, for the bf16 outputs and the
    fp32 ones alike: the JAX kernel's rational erf (|err| < 1.5e-7) against
    the port's exact erf can flip the rounding of single g or dh entries."""
    got = np.asarray(got, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    else:
        assert np.abs(got - want).max() <= _bf16_ulp(want), name
        assert np.abs(got - want).mean() <= 1e-3, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_forward_matches_jax(jax_reference, dtype):
    a, ref = jax_reference
    got = TX.expert_ffn(*_port_args(a, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), ref[dtype][0], dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("through", ["autograd", "explicit"])
def test_expert_ffn_gradients_match_jax(jax_reference, through, dtype):
    a, ref = jax_reference
    args = _port_args(a, getattr(torch, dtype))
    dout = torch.from_numpy(a["dout"]).to(getattr(torch, dtype))
    if through == "autograd":
        leaves = [t.clone().requires_grad_() for t in args]
        TX.expert_ffn(*leaves).backward(dout)
        got = [t.grad for t in leaves]
        assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    else:
        got = TX.expert_ffn_bwd(*args, dout)
    for name, g, w in zip(["dx", "dw1", "db1", "dw2", "db2"], got, ref[dtype][1]):
        _close(g.float().numpy(), w, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 192, 128, 256)])
def test_expert_ffn_gradients_match_jax_at_ragged_slot_rows(shape, dtype):
    """The five gradients of :func:`expert_ffn_bwd_reference` against JAX's
    ``_expert_ffn_bwd`` (interpret mode) at a slot count the JAX gate admits
    that is not a multiple of 128, by the file's tolerances."""
    a = _inputs(1, *shape)
    dt = getattr(jnp, dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        assert JX.expert_ffn_ok(*shape) and shape[1] % 128
        _, vjp = jax.vjp(JX.expert_ffn, jnp.asarray(a["x"], dt),
                         *(jnp.asarray(a[k]) for k in ("w1", "b1", "w2", "b2")))
        want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(a["dout"], dt))]
    got = TX.expert_ffn_bwd_reference(*_port_args(a, getattr(torch, dtype)),
                                      torch.from_numpy(a["dout"]).to(getattr(torch, dtype)))
    for name, g, w in zip(["dx", "dw1", "db1", "dw2", "db2"], got, want):
        _close(g.float().numpy(), w, dtype, name)
