"""Parity of the port's DiT tail, X4 (``ddm_tpu_torch/ops/ln_dense.py``), with
the JAX package on the CPU.

- The port's plain X4, ``ln_dense_reference`` forward and
  ``ln_dense_bwd_reference`` backward (through ``fused_ln_dense``'s
  autograd Function), against the X4 Pallas body in interpret mode: the
  added lines of ``tools/exp_ln_dense.patch``'s second hunk exec'd in a
  copy of ``ddm_tpu.ops.mlp_block``'s namespace (nothing on disk is
  patched), its plain fallback made to raise so that the kernels run.
- The port's ``DDDMDiT.head_tokens`` and its gradients against the
  unpatched JAX ``DDDMDiT.head_tokens`` (flax's LayerNorm and Dense), the
  weights carried by ``state_dict_from_jax``.
- The gate's table, beside the JAX gate's shape terms.

Tolerances: fp32, 1e-5 relative to the largest entry of each output; bf16,
within 2e of JAX's bf16 result in max and mean, e = |JAX bf16 - JAX fp32|
being bf16's own noise on that output (the rule of
``tests/test_torch_training.py``), and no tighter than the fp32 rule where
an output does not depend on the dtype (the bias gradient sums the fp32
cotangent in both, so e is zero there).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT  # noqa: E402
from ddm_tpu_torch.ops import ln_dense as TLD  # noqa: E402
from ddm_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

PATCH = pathlib.Path(__file__).resolve().parents[1] / "tools" / "exp_ln_dense.patch"
SHAPES = [(256, 128, 48), (512, 384, 48), (256, 256, 12)]
F32_RTOL = 1e-5


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    """Pallas in interpret mode; the JAX plain versions raise if reached."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain version, not the Pallas kernel")

    monkeypatch.setattr(JM, "mlp_block_reference", boom)
    monkeypatch.setattr(JA, "attention_block_reference", boom)


def _x4_namespace():
    """The X4 Pallas body: the second hunk's added lines, exec'd in a copy of
    ``ddm_tpu.ops.mlp_block``'s namespace, with its plain fallback raising."""
    lines = PATCH.read_text().splitlines()
    hunks = [i for i, line in enumerate(lines) if line.startswith("@@")]
    body = [line[1:] for line in lines[hunks[1] + 1:] if line.startswith("+")]
    ns = dict(vars(JM))
    exec(compile("\n".join(body), str(PATCH), "exec"), ns)  # noqa: S102

    def boom(*a, **k):
        raise AssertionError("the X4 body took its plain fallback, not the Pallas kernels")

    ns["ln_dense_reference"] = boom
    return ns


def _inputs(T, D, K, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((T, D)).astype(np.float32),
            (1 + 0.1 * r.standard_normal(D)).astype(np.float32),
            (0.1 * r.standard_normal(D)).astype(np.float32),
            (D ** -0.5 * r.standard_normal((D, K))).astype(np.float32),
            (0.1 * r.standard_normal(K)).astype(np.float32),
            r.standard_normal((T, K)).astype(np.float32))


def _jax_x4(ns, dtype, x, scale, bias, w, b, dout):
    primals = (jnp.asarray(x, dtype), *(jnp.asarray(a) for a in (scale, bias, w, b)))
    out, vjp = jax.vjp(ns["fused_ln_dense"], *primals)
    return [np.asarray(t, np.float32) for t in (out, *vjp(jnp.asarray(dout)))]


def _port_x4(dtype, x, scale, bias, w, b, dout):
    leaves = [torch.from_numpy(x).to(dtype)] + [torch.from_numpy(a) for a in (scale, bias, w, b)]
    leaves = [t.requires_grad_() for t in leaves]
    out = TLD.fused_ln_dense(*leaves)
    out.backward(torch.from_numpy(dout))
    return [t.detach().float().numpy() for t in [out] + [a.grad for a in leaves]]


def _assert_f32(got, want, what):
    tol = F32_RTOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=tol, err_msg=what)


def _assert_bf16(got, want, want32, what):
    """Within 2e of JAX's bf16 result (max and mean), e = |JAX bf16 - JAX
    fp32|; the fp32 rule where e vanishes."""
    floor = F32_RTOL * float(np.abs(want).max())
    noise, d = np.abs(want - want32), np.abs(got - want)
    assert d.max() <= max(2 * noise.max(), floor), what
    assert d.mean() <= max(2 * noise.mean(), floor), what


LABELS = ("out", "dx", "dscale", "dbias", "dW", "db")


@pytest.mark.parametrize("T,D,K", SHAPES)
def test_plain_x4_matches_the_pallas_body(jax_kernels_only, T, D, K):
    """fp32 and bf16, forward and every gradient, on one numpy draw."""
    ns = _x4_namespace()
    inputs = _inputs(T, D, K, seed=T + D + K)
    want32 = _jax_x4(ns, jnp.float32, *inputs)
    want16 = _jax_x4(ns, jnp.bfloat16, *inputs)
    got32 = _port_x4(torch.float32, *inputs)
    got16 = _port_x4(torch.bfloat16, *inputs)
    for lab, g, w in zip(LABELS, got32, want32):
        _assert_f32(g, w, f"fp32 {lab}")
    for lab, g, w, w32 in zip(LABELS, got16, want16, want32):
        assert g.shape == w.shape, lab
        _assert_bf16(g, w, w32, f"bf16 {lab}")


def test_cpu_function_takes_the_plain_pair():
    """On CPU tensors the Function's forward is ln_dense_reference and its
    backward ln_dense_bwd_reference, bit for bit, and no kernel counts."""
    x, scale, bias, w, b, dout = (torch.from_numpy(a) for a in _inputs(64, 128, 48, seed=3))
    x = x.to(torch.bfloat16)
    before = (TLD.FWD_LAUNCHES.count, TLD.BWD_LAUNCHES.count)
    got = _port_x4(torch.bfloat16, *(t.float().numpy() for t in (x, scale, bias, w, b, dout)))
    assert np.array_equal(got[0], TLD.ln_dense_reference(x, scale, bias, w, b).numpy())
    want = TLD.ln_dense_bwd_reference(x, scale, bias, w, dout)
    for g, h in zip(got[1:], want):
        assert np.array_equal(g, h.float().numpy())
    assert (TLD.FWD_LAUNCHES.count, TLD.BWD_LAUNCHES.count) == before


CFG = dict(img=16, patch=4, dim=128, tdim=32)
B = 4


def _jax_model(dtype):
    return JaxDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"], depth=1,
                  num_heads=2, time_embed_dim=CFG["tdim"], dtype=dtype, data_format="NHWC")


@pytest.fixture(scope="module")
def tail_case():
    x0 = jnp.zeros((1, CFG["img"], CFG["img"], 3))
    variables = _jax_model(jnp.float32).init(jax.random.PRNGKey(5), x0, jnp.zeros((1,)), x0)
    r = np.random.default_rng(6)  # non-trivial LN parameters and biases
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)
    N = (CFG["img"] // CFG["patch"]) ** 2
    h = r.standard_normal((B, N, CFG["dim"])).astype(np.float32)
    dout = r.standard_normal((B, N, 3 * CFG["patch"] ** 2)).astype(np.float32)
    return variables, h, dout


def _jax_tail(variables, h, dout, dtype):
    model = _jax_model(dtype)

    def f(v, h_):
        return model.apply(v, h_, method="head_tokens")

    out, vjp = jax.vjp(f, variables, jnp.asarray(h, dtype))
    dv, dh = vjp(jnp.asarray(dout))
    sd = state_dict_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), dv),
                             patch_size=CFG["patch"])
    grads = {k: np.asarray(sd[k], np.float32) for k in TAIL_PARAMS}
    return np.asarray(out, np.float32), np.asarray(dh, np.float32), grads


TAIL_PARAMS = ("norm.weight", "norm.bias", "unembed.proj.weight", "unembed.proj.bias")


def _port_tail(variables, h, dout, dtype):
    model = DDDMDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"], depth=1,
                    num_heads=2, time_embed_dim=CFG["tdim"], dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]))
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    out = model.head_tokens(ht)
    out.backward(torch.from_numpy(dout))
    params = dict(model.named_parameters())
    grads = {k: params[k].grad.float().numpy() for k in TAIL_PARAMS}
    return out.detach().numpy(), ht.grad.float().numpy(), grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_tokens_and_grads_match_the_jax_tail(tail_case, dtype):
    """The port's head_tokens (the plain X4 on CPU tensors) against the
    unpatched JAX head_tokens: the tokens, dh and the four tail gradients."""
    variables, h, dout = tail_case
    got = _port_tail(variables, h, dout, getattr(torch, dtype))
    want = _jax_tail(variables, h, dout, getattr(jnp, dtype))
    pairs = [("tokens", got[0], want[0]), ("dh", got[1], want[1])] + \
        [(k, got[2][k], want[2][k]) for k in TAIL_PARAMS]
    if dtype == "float32":
        for lab, g, w in pairs:
            _assert_f32(g, w, lab)
        return
    want32 = _jax_tail(variables, h, dout, jnp.float32)
    ref32 = [want32[0], want32[1]] + [want32[2][k] for k in TAIL_PARAMS]
    for (lab, g, w), w32 in zip(pairs, ref32):
        assert g.shape == w.shape, lab
        _assert_bf16(g, w, w32, lab)


@pytest.mark.parametrize("T,D,K,takes", [
    (131072, 384, 48, True), (16384, 384, 48, True), (131072, 768, 48, True),
    (131072, 1024, 48, True), (131072, 1152, 48, True), (131072, 1536, 48, True),
    (32768, 6144, 48, True), (1, 128, 1, True), (1000, 256, 512, True), (300, 384, 12, True),
    (131072, 64, 48, False), (131072, 1472, 48, False), (4096, 480, 48, False),
    (4096, 384, 513, False), (0, 384, 48, False), (4096, 384, 0, False)])
def test_gate_table(jax_kernels_only, T, D, K, takes):
    """The gate takes every T, D % 128 == 0 and K <= 512; where the JAX
    gate's VMEM term holds (and T is a multiple of its row block), it
    agrees with the JAX gate, and it takes every shape the JAX gate takes."""
    assert TLD.ln_dense_takes(T, D, K) is takes
    ns = _x4_namespace()
    rb = ns["_ln_dense_rb"](T) if T else 8
    vmem = D * K * 8 + rb * D * 22 < 14 * 1024 * 1024
    if T and K and T % rb == 0 and vmem:  # the JAX gate has no term for K = 0
        assert ns["_ln_dense_ok"](T, D, K) is takes
    if T and K and ns["_ln_dense_ok"](T, D, K):
        assert takes
