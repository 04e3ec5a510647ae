"""The port's phase-batched attention experiment, X1
(``ddm_tpu_torch/ops/phase_softmax.py``), on the CPU.

- ``tools/exp_phase_softmax.py``'s three bodies, imported by file path and
  run in interpret mode (the JAX plain half-block raises if reached):
  ``phase_fwd_call`` against :func:`phase_attention_block_fwd`, and
  ``phase_bwd_call`` and ``persist_bwd_call`` against
  :func:`phase_attention_block_bwd`, at (B 3, N 16, D 128, H 2), where the
  TPU packs one image (g = 1), and at B 8 (g = 8): fp32 within 1e-5 of the
  largest output; bf16 within 2e of JAX's bf16 result in max and mean, e =
  |JAX bf16 - JAX fp32|.
- On CPU tensors the port runs the production plain half-block, bit for
  bit, and no kernel launch is counted.
- The gate's table, and the refusals, which name ROADMAP item 14.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import phase_softmax as TP  # noqa: E402

EXP = pathlib.Path(__file__).resolve().parents[1] / "tools" / "exp_phase_softmax.py"
F32_RTOL = 1e-5
SHAPES = [(3, 16, 128, 2), (8, 16, 128, 2)]  # g = 1 and g = 8 on the TPU
GRADS = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    """Pallas in interpret mode; the JAX plain half-block raises if reached."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain version, not the Pallas kernel")

    monkeypatch.setattr(JA, "attention_block_reference", boom)


def _exp():
    spec = importlib.util.spec_from_file_location("exp_phase_softmax", EXP)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(B, N, D, seed=0):
    """x, the six half-block parameters in nn.Linear's layout (the port's),
    and a cotangent."""
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0, off=0.0: (off + sc * r.standard_normal(s)).astype(np.float32)  # noqa
    return (n(B, N, D), n(D, sc=0.1, off=1.0), n(D, sc=0.1), n(3 * D, D, sc=D ** -0.5),
            n(3 * D, sc=0.1), n(D, D, sc=D ** -0.5), n(D, sc=0.1), n(B, N, D))


def _jax(fn, inputs, H, dtype):
    """One of the tool's calls, weights in JAX's (in, out) layout; the
    backward's outputs in the port's layout (weights (out, in), vectors)."""
    x, s, b, wqkv, bqkv, wproj, bproj, do = inputs
    args = (jnp.asarray(x, dtype), s, b, wqkv.T, bqkv, wproj.T, bproj)
    if fn == "phase_fwd_call":
        return [np.asarray(_exp().phase_fwd_call(*args, H), np.float32)]
    outs = [np.asarray(o, np.float32) for o in
            getattr(_exp(), fn)(*args, jnp.asarray(do, dtype), H)]
    dx, ds, db, dwqkv, dbqkv, dwproj, dbproj = outs
    return [dx, ds[0], db[0], dwqkv.T, dbqkv[0], dwproj.T, dbproj[0]]


def _port(fn, inputs, H, dtype):
    x, *p, do = (torch.from_numpy(a) for a in inputs)
    x, do = x.to(dtype), do.to(dtype)
    if fn == "phase_fwd_call":
        return [TP.phase_attention_block_fwd(x, *p, H).float().numpy()]
    return [g.float().numpy() for g in TP.phase_attention_block_bwd(x, *p, H, do)]


@pytest.mark.parametrize("fn", ["phase_fwd_call", "phase_bwd_call", "persist_bwd_call"])
@pytest.mark.parametrize("B,N,D,H", SHAPES)
def test_matches_the_jax_phase_kernels(jax_kernels_only, fn, B, N, D, H):
    inputs = _inputs(B, N, D, seed=B)
    want32, want16 = (_jax(fn, inputs, H, dt) for dt in (jnp.float32, jnp.bfloat16))
    got32, got16 = (_port(fn, inputs, H, dt) for dt in (torch.float32, torch.bfloat16))
    for i, (g32, w32, g16, w16) in enumerate(zip(got32, want32, got16, want16)):
        name = f"{fn} {GRADS[i] if len(got32) > 1 else 'out'}"
        tol = F32_RTOL * float(np.abs(w32).max())
        np.testing.assert_allclose(g32, w32, rtol=F32_RTOL, atol=tol, err_msg=name)
        noise, d = np.abs(w16 - w32), np.abs(g16 - w16)
        assert noise.max() > 0, name  # bf16's noise is real
        assert d.max() <= 2 * noise.max() and d.mean() <= 2 * noise.mean(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_production_plain_versions(dtype):
    B, N, D, H = SHAPES[0]
    x, *p, do = (torch.from_numpy(a) for a in _inputs(B, N, D, seed=11))
    x, do = x.to(dtype), do.to(dtype)
    before = (TP.LAUNCHES.count, TP.BWD_LAUNCHES.count)
    assert torch.equal(TP.phase_attention_block_fwd(x, *p, H),
                       TA.attention_block_reference(x, *p, H))
    for g, w in zip(TP.phase_attention_block_bwd(x, *p, H, do),
                    TA.attention_block_bwd_reference(x, *p, H, do)):
        assert torch.equal(g, w)
    assert (TP.LAUNCHES.count, TP.BWD_LAUNCHES.count) == before


@pytest.mark.parametrize("B,N,D,H,takes", [
    (2048, 64, 384, 6, True), (256, 64, 384, 6, True), (2048, 64, 768, 12, True),
    (3, 16, 128, 2, True), (8, 16, 128, 2, True), (5, 48, 320, 8, True),
    (8, 64, 384, 48, False), (2048, 256, 384, 6, False), (8, 128, 384, 6, False),
    (8, 40, 384, 6, False), (8, 64, 384, 5, False), (8, 64, 96, 2, False),
    (8, 64, 1152, 16, False), (8, 64, 384, 3, False), (8, 64, 896, 14, False),
    (0, 64, 384, 6, False)])
def test_gate_table(B, N, D, H, takes):
    assert TP.phase_softmax_takes(B, N, D, H) is takes


@pytest.mark.parametrize("B,N,D,H", [(2, 256, 384, 6), (2, 64, 1536, 24), (2, 48, 96, 2)])
def test_refusals_name_roadmap_item_14(B, N, D, H):
    x, *p, do = (torch.from_numpy(a) for a in _inputs(B, N, D, seed=3))
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 14"):
        TP.phase_attention_block_fwd(x, *p, H)
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 14"):
        TP.phase_attention_block_bwd(x, *p, H, do)
