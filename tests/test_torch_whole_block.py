"""The port's whole-block experiment, X2 (``ddm_tpu_torch/ops/whole_block.py``),
on the CPU.

- ``whole_block_reference`` (what ``whole_block_fwd`` runs on CPU tensors) is
  the port's plain pair, the attention half-block's plain version then the
  MLP half-block's, bit for bit, in fp32 and bf16.
- It matches ``tools/exp_whole_block.py``'s ``merged_call`` and
  ``pair_call``, imported by file path and run in interpret mode (the JAX
  plain half-blocks raise if reached), at (B 8, N 16, D 128, H 2, F 512):
  fp32 within 1e-5 relative to the largest output; bf16 within 2e of JAX's
  bf16 result in max and mean, e = |JAX bf16 - JAX fp32|.
- The gate's table, and the refusal, which names ROADMAP item 14.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu_torch.ops import whole_block as TW  # noqa: E402
from ddm_tpu_torch.ops.attention import attention_block_reference  # noqa: E402
from ddm_tpu_torch.ops.mlp_block import mlp_block_reference  # noqa: E402

EXP = pathlib.Path(__file__).resolve().parents[1] / "tools" / "exp_whole_block.py"
SHAPE = (8, 16, 128, 2, 512)  # B, N, D, H, F
F32_RTOL = 1e-5


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    """Pallas in interpret mode; the JAX plain versions raise if reached."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain version, not the Pallas kernel")

    monkeypatch.setattr(JM, "mlp_block_reference", boom)
    monkeypatch.setattr(JA, "attention_block_reference", boom)


def _exp():
    spec = importlib.util.spec_from_file_location("exp_whole_block", EXP)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(B, N, D, F, seed=0):
    """x and the 12 block parameters in nn.Linear's layout (the port's)."""
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0, off=0.0: (off + sc * r.standard_normal(s)).astype(np.float32)  # noqa
    return (n(B, N, D), n(D, sc=0.1, off=1.0), n(D, sc=0.1), n(3 * D, D, sc=D ** -0.5),
            n(3 * D, sc=0.1), n(D, D, sc=D ** -0.5), n(D, sc=0.1), n(D, sc=0.1, off=1.0),
            n(D, sc=0.1), n(F, D, sc=D ** -0.5), n(F, sc=0.1), n(D, F, sc=F ** -0.5),
            n(D, sc=0.1))


def _port(inputs, H, dtype):
    x, *p = (torch.from_numpy(a) for a in inputs)
    return TW.whole_block_fwd(x.to(dtype), *p, H)


def _jax(exp, fn, inputs, H, dtype):
    """``merged_call`` or ``pair_call``, weights in JAX's (in, out) layout."""
    x, s1, b1, wqkv, bqkv, wproj, bproj, s2, b2, w1, bb1, w2, bb2 = inputs
    out = getattr(exp, fn)(jnp.asarray(x, dtype), s1, b1, wqkv.T, bqkv, wproj.T, bproj, s2, b2,
                           w1.T, bb1, w2.T, bb2, H)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_is_the_plain_pair_bit_for_bit(dtype):
    B, N, D, H, F = SHAPE
    inputs = _inputs(B, N, D, F, seed=1)
    x, *p = (torch.from_numpy(a) for a in inputs)
    x = x.to(dtype)
    a = attention_block_reference(x, *p[:6], H)
    want = mlp_block_reference(a.reshape(B * N, D), *p[6:]).reshape(B, N, D)
    assert torch.equal(TW.whole_block_reference(x, *p, H), want)
    before = TW.LAUNCHES.count
    assert torch.equal(TW.whole_block_fwd(x, *p, H), want)  # CPU tensors: the plain pair
    assert TW.LAUNCHES.count == before


def test_matches_the_jax_merged_and_pair_kernels(jax_kernels_only):
    B, N, D, H, F = SHAPE
    exp = _exp()
    inputs = _inputs(B, N, D, F, seed=2)
    want32 = {fn: _jax(exp, fn, inputs, H, jnp.float32) for fn in ("merged_call", "pair_call")}
    want16 = {fn: _jax(exp, fn, inputs, H, jnp.bfloat16) for fn in ("merged_call", "pair_call")}
    got32 = _port(inputs, H, torch.float32).numpy()
    got16 = _port(inputs, H, torch.bfloat16).float().numpy()
    for fn in ("merged_call", "pair_call"):
        tol = F32_RTOL * float(np.abs(want32[fn]).max())
        np.testing.assert_allclose(got32, want32[fn], rtol=F32_RTOL, atol=tol, err_msg=fn)
        noise = np.abs(want16[fn] - want32[fn])
        d = np.abs(got16 - want16[fn])
        assert 0 < noise.max() < 0.25, fn  # bf16's noise is real and small
        assert d.max() <= 2 * noise.max() and d.mean() <= 2 * noise.mean(), fn


@pytest.mark.parametrize("B,N,D,H,F,takes", [
    (256, 64, 384, 6, 1536, True), (64, 16, 384, 6, 1536, True), (5, 32, 384, 6, 1536, True),
    (7, 48, 256, 4, 1024, True), (8, 16, 128, 2, 512, True), (256, 64, 384, 3, 1536, True),
    (256, 64, 384, 1, 1536, False), (256, 64, 384, 16, 1536, False),
    (256, 256, 384, 6, 1536, False), (256, 64, 768, 12, 3072, False),
    (256, 40, 384, 6, 1536, False), (256, 64, 384, 6, 1000, False), (0, 64, 384, 6, 1536, False)])
def test_gate_table(B, N, D, H, F, takes):
    assert TW.whole_block_takes(B, N, D, H, F) is takes


@pytest.mark.parametrize("B,N,D,H,F", [(2, 64, 768, 12, 3072), (2, 256, 384, 6, 1536),
                                       (2, 64, 384, 16, 1536)])
def test_refusal_names_roadmap_item_14(B, N, D, H, F):
    inputs = _inputs(B, N, D, F, seed=3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 14"):
        _port(inputs, H, torch.bfloat16)
