"""Parity of the port's F-chunked forwards with the JAX package's, whose
Pallas kernels run in interpret mode on the same numpy inputs:

- the MLP partial (K5/K6f, whose plain version the port's CPU path runs)
  against ``_fused_partial_fwd_call``, on a whole hidden axis and on a
  column chunk read in place;
- the F-chunked MLP half-block against ``_fused_fwdonly_fchunked`` with
  k forced to 2 (its forward and the seven gradients of its XLA backward);
- the expert FFN's F-chunked partials (K10p) against ``_fwd_call_chunked``
  at k = 2 and 4, and through ``_expert_ffn_fwdonly`` with its gradients.

The port runs on CPU tensors (its plain versions), with its tier forced
where the shape would not pick it; the CUDA kernels are held to these plain
versions on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.expert_ffn as JX  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402

T, D, F = 128, 128, 512
E, S = 4, 128
NAMES = ["x", "scale", "bias", "w1", "b1", "w2", "b2"]


def _bf16_ulp(want) -> float:
    top = float(np.abs(np.asarray(want, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(max(top, 1e-30))) - 7)


def _close(got, want, dtype, name):
    """fp32: 1e-4 relative (fp32 sums taken in another order, chunk sums
    included), the absolute part scaled by the largest entry. bf16: one bf16
    unit at the largest entry and a mean far below it: the JAX kernel's
    rational erf (|err| < 1.5e-7) against the port's exact erf, and fp32
    sums in another order, can flip the rounding of single bf16 g or output
    entries."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=name)
    else:
        assert np.abs(got - want).max() <= _bf16_ulp(want), name
        assert np.abs(got - want).mean() <= 1e-3, name


def _mlp_inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(x=r.standard_normal((T, D)), scale=1 + 0.1 * r.standard_normal(D),
                bias=0.1 * r.standard_normal(D), w1=D ** -0.5 * r.standard_normal((D, F)),
                b1=0.1 * r.standard_normal(F), w2=F ** -0.5 * r.standard_normal((F, D)),
                b2=0.1 * r.standard_normal(D), dout=r.standard_normal((T, D)))


def _f32(a):
    return {k: np.asarray(v, np.float32) for k, v in a.items()}


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", ["whole", "second of two"])
def test_mlp_partial_matches_jax_kernel(interpret, dtype, chunk):
    a = _f32(_mlp_inputs())
    lo, hi = (0, F) if chunk == "whole" else (F // 2, F)
    dt = getattr(jnp, dtype)
    want = JM._fused_partial_fwd_call(
        jnp.asarray(a["x"], dt), jnp.asarray(a["scale"]), jnp.asarray(a["bias"]),
        jnp.asarray(a["w1"][:, lo:hi]), jnp.asarray(a["b1"][lo:hi]),
        jnp.asarray(a["w2"][lo:hi]))
    assert want.dtype == jnp.float32
    # the port's weights in nn.Linear's layout; the chunk as views of them
    w1, w2 = torch.from_numpy(a["w1"].T.copy()), torch.from_numpy(a["w2"].T.copy())
    got = TM.mlp_partial_reference(torch.from_numpy(a["x"]).to(getattr(torch, dtype)),
                                   torch.from_numpy(a["scale"]), torch.from_numpy(a["bias"]),
                                   w1[lo:hi], torch.from_numpy(a["b1"][lo:hi]), w2[:, lo:hi])
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), dtype, "partial")


def _jax_chunked(a, dtype, monkeypatch):
    """The JAX F-chunked half-block (k = 2) and its seven gradients."""
    monkeypatch.setattr(JM, "_mlp_fwd_fchunks", lambda *s: 2)
    dt = getattr(jnp, dtype)
    args = [jnp.asarray(a["x"], dt)] + [jnp.asarray(a[k]) for k in NAMES[1:]]
    y, vjp = jax.vjp(JM._fused_fwdonly_fchunked, *args)
    grads = vjp(jnp.asarray(a["dout"], dt))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fchunked_mlp_block_matches_jax(interpret, monkeypatch, dtype):
    """Forward to the rule above; gradients as tests/test_torch_backward.py
    holds K1b: fp32 1e-4 / 1e-5, bf16 1e-2 / 3.2e-2 (XLA's backward returns
    the weight cotangents rounded to bf16 where the port keeps fp32)."""
    a = _f32(_mlp_inputs(seed=1))
    want_out, want = _jax_chunked(a, dtype, monkeypatch)
    calls = []
    real = TM.mlp_block_fchunked_reference
    monkeypatch.setattr(tiers, "mlp_tier", lambda *s: ("fchunked", 2))
    monkeypatch.setattr(TM, "mlp_block_fchunked_reference",
                        lambda *args: calls.append(args[7]) or real(*args))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a["x"]).to(tdt)] + [
        torch.from_numpy(a[k].T.copy() if a[k].ndim == 2 else a[k]) for k in NAMES[1:]]
    leaves = [t.requires_grad_() for t in leaves]
    out = TM.fused_mlp_block(*leaves)
    out.backward(torch.from_numpy(a["dout"]).to(tdt))
    assert calls == [2]
    _close(out.detach().float().numpy(), want_out, dtype, "out")
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=3.2e-2)
    for i, (name, t, w) in enumerate(zip(NAMES, leaves, want)):
        g = (t.grad.t() if t.grad.dim() == 2 and i else t.grad).float().numpy()
        np.testing.assert_allclose(g, w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"gradient of {name}")


def test_fchunked_sum_order_is_the_jax_order():
    """The plain chunked forward sums the k fp32 partials in chunk order and
    rounds (x + sum) + b2 once: bit for bit the same sum built by hand."""
    a = _f32(_mlp_inputs(seed=2))
    x = torch.from_numpy(a["x"]).to(torch.bfloat16)
    w1, w2 = torch.from_numpy(a["w1"].T.copy()), torch.from_numpy(a["w2"].T.copy())
    s, b, b1, b2 = (torch.from_numpy(a[k]) for k in ("scale", "bias", "b1", "b2"))
    q = F // 4
    parts = [TM.mlp_partial_reference(x, s, b, w1[c * q:(c + 1) * q], b1[c * q:(c + 1) * q],
                                      w2[:, c * q:(c + 1) * q]) for c in range(4)]
    acc = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    want = ((x.float() + acc) + b2).to(torch.bfloat16)
    assert torch.equal(TM.mlp_block_fchunked_reference(x, s, b, w1, b1, w2, b2, 4), want)


def _expert_inputs(seed=4):
    r = np.random.default_rng(seed)
    x = r.standard_normal((E, S, D))
    x[:, S - 24:] = 0.0  # empty slot rows, as the dispatch leaves them
    return _f32(dict(x=x, w1=(E * D) ** -0.5 * r.standard_normal((E, D, F)),
                     b1=0.1 * r.standard_normal((E, F)),
                     w2=(E * F) ** -0.5 * r.standard_normal((E, F, D)),
                     b2=0.1 * r.standard_normal((E, D)), dout=r.standard_normal((E, S, D))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
def test_expert_partials_match_jax_kernel(interpret, dtype, k):
    a = _expert_inputs()
    dt = getattr(jnp, dtype)
    want = JX._fwd_call_chunked(jnp.asarray(a["x"], dt),
                                *(jnp.asarray(a[n]) for n in ("w1", "b1", "w2", "b2")), k)
    args = [torch.from_numpy(a["x"]).to(getattr(torch, dtype))] + [
        torch.from_numpy(a[n]) for n in ("w1", "b1", "w2", "b2")]
    got = TX.expert_ffn_fchunked_reference(*args, k)
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), dtype, f"k={k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_fwdonly_tier_matches_jax(interpret, monkeypatch, dtype):
    """The wide tier through each package's dispatch, k = 2 forced in both:
    the forward by the rule above, and the five gradients of K10b's plain
    chain against XLA's backward of the reference, to the MLP test's
    tolerances (XLA returns the weight cotangents rounded to bf16, half a
    bf16 unit on average, where K10b keeps fp32)."""
    a = _expert_inputs(seed=5)
    monkeypatch.setattr(JX, "expert_ffn_ok", lambda *s: False)
    monkeypatch.setattr(JX, "_expert_fwd_fchunks", lambda *s: 2)
    dt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a["x"], dt)] + [jnp.asarray(a[n]) for n in ("w1", "b1", "w2", "b2")]
    y, vjp = jax.vjp(lambda *t: JX.expert_ffn_auto(*t, dtype=dt), *jargs)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(a["dout"], dt))]

    monkeypatch.setattr(tiers, "expert_tier", lambda *s: ("fwdonly", 2))
    calls = []
    real = TX.expert_ffn_fchunked_reference
    monkeypatch.setattr(TX, "expert_ffn_fchunked_reference",
                        lambda *t: calls.append(t[5]) or real(*t))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a["x"]).to(tdt)] + [torch.from_numpy(a[n])
                                                   for n in ("w1", "b1", "w2", "b2")]
    leaves = [t.requires_grad_() for t in leaves]
    out = TX.expert_ffn(*leaves)
    out.backward(torch.from_numpy(a["dout"]).to(tdt))
    assert calls == [2]
    _close(out.detach().float().numpy(), np.asarray(y.astype(jnp.float32)), dtype, "out")
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=3.2e-2)
    for name, t, w in zip(["dx", "dw1", "db1", "dw2", "db2"], leaves, want):
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"gradient {name}")
