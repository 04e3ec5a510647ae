"""The port's attention-backward ablation, X3
(``ddm_tpu_torch/ops/attention_ablate.py``), on the CPU.

- ``tools/kbench_ablate.py``'s ``run_bwd_variant``, imported by file path
  with its ``pl`` patched to interpret mode (the file calls
  ``pl.pallas_call`` directly), against :func:`attention_block_bwd_ablate`
  for each of the tool's eight variants at (B 3, N 16, D 128, H 2): fp32
  within 1e-5 of the largest output; bf16 within 2e of JAX's bf16 result in
  max and mean, e = |JAX bf16 - JAX fp32|. Only where the TPU packs one
  image (g = 1, odd B): ``run_bwd_variant`` passes an all-zero mask
  (``kbench_ablate.py:199``), so at g > 1 its queries attend across the
  images of a pack, where the port's cores work per image.
- K1f with the tool's identity GELU (``_gelu`` patched, restored after)
  against :func:`mlp_block_fwd_identity_gelu`, by the same rule.
- The all-off plain version is the production backward's bit for bit, the
  flags' core codes, the gate's table and the refusals, which name ROADMAP
  item 14.
"""

import functools
import importlib.util
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

torch = pytest.importorskip("torch")

import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import attention_ablate as TX  # noqa: E402

TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "kbench_ablate.py"
F32_RTOL = 1e-5
SHAPE = (3, 16, 128, 2)  # B, N, D, H: odd B, so the TPU packs one image (g = 1)
GRADS = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")


def _tool():
    """The tool's module with ``pl.pallas_call`` in interpret mode."""
    spec = importlib.util.spec_from_file_location("kbench_ablate", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), when=pl.when,
        program_id=pl.program_id)
    return module


def _inputs(B, N, D, seed=0):
    """x, the six half-block parameters in nn.Linear's layout (the port's),
    and a cotangent."""
    r = np.random.default_rng(seed)
    n = lambda *s, sc=1.0, off=0.0: (off + sc * r.standard_normal(s)).astype(np.float32)  # noqa
    return (n(B, N, D), n(D, sc=0.1, off=1.0), n(D, sc=0.1), n(3 * D, D, sc=D ** -0.5),
            n(3 * D, sc=0.1), n(D, D, sc=D ** -0.5), n(D, sc=0.1), n(B, N, D))


def _jax_variant(tool, inputs, H, dtype, skips):
    """``run_bwd_variant``'s seven outputs in the port's layout."""
    x, s, b, wqkv, bqkv, wproj, bproj, do = inputs
    flags = {k: bool(skips.get(k, False)) for k in TX.SKIPS}
    outs = tool.run_bwd_variant(jnp.asarray(x, dtype), s, b, wqkv.T, bqkv, wproj.T, bproj,
                                jnp.asarray(do, dtype), H, **flags)
    dx, ds, db, dwqkv, dbqkv, dwproj, dbproj = (np.asarray(o, np.float32) for o in outs)
    return [dx, ds[0], db[0], dwqkv.T, dbqkv[0], dwproj.T, dbproj[0]]


def _port_variant(inputs, H, dtype, skips):
    x, *p, do = (torch.from_numpy(a) for a in inputs)
    grads = TX.attention_block_bwd_ablate(x.to(dtype), *p, H, do.to(dtype), **skips)
    return [g.float().numpy() for g in grads]


def _assert_rule(name, g32, w32, g16, w16):
    tol = F32_RTOL * float(np.abs(w32).max())
    np.testing.assert_allclose(g32, w32, rtol=F32_RTOL, atol=tol, err_msg=name)
    noise, d = np.abs(w16 - w32), np.abs(g16 - w16)
    assert d.max() <= 2 * noise.max() and d.mean() <= 2 * noise.mean(), name


@pytest.mark.parametrize("variant", [name for name, _ in TX.VARIANTS])
def test_matches_the_jax_ablation_kernel_at_one_image_a_pack(variant):
    skips = dict(TX.VARIANTS)[variant]
    B, N, D, H = SHAPE
    tool = _tool()
    inputs = _inputs(B, N, D, seed=len(variant))
    want32, want16 = (_jax_variant(tool, inputs, H, dt, skips) for dt in (jnp.float32,
                                                                          jnp.bfloat16))
    got32, got16 = (_port_variant(inputs, H, dt, skips) for dt in (torch.float32,
                                                                   torch.bfloat16))
    for i, name in enumerate(GRADS):
        if name == "dwproj" and skips.get("skip_softmax"):
            # the tool's r2 body recomputes att with a softmax of its own; the
            # port's core, as K2b's, computes one P for att, dv and dS, so
            # with the softmax removed its att (and dWproj over it) is
            # bf16(bf16(S scale) V): held to the plain version on the card
            continue
        _assert_rule(f"{variant} {name}", got32[i], want32[i], got16[i], want16[i])


def test_identity_gelu_k1f_matches_the_tool(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JM, "_gelu", _tool()._gelu_id)
    T, D, F = 48, 128, 512
    r = np.random.default_rng(7)
    n = lambda *s, sc=1.0, off=0.0: (off + sc * r.standard_normal(s)).astype(np.float32)  # noqa
    x, s, b, w1, b1, w2, b2 = (n(T, D), n(D, sc=0.1, off=1.0), n(D, sc=0.1),
                               n(F, D, sc=D ** -0.5), n(F, sc=0.1), n(D, F, sc=F ** -0.5),
                               n(D, sc=0.1))
    want = {dt: np.asarray(JM._fused_fwd_call(jnp.asarray(x, dt), s, b, w1.T, b1, w2.T, b2),
                           np.float32) for dt in (jnp.float32, jnp.bfloat16)}
    p = [torch.from_numpy(a) for a in (s, b, w1, b1, w2, b2)]
    got = {dt: TX.mlp_block_fwd_identity_gelu(torch.from_numpy(x).to(dt), *p).float().numpy()
           for dt in (torch.float32, torch.bfloat16)}
    _assert_rule("identity-gelu K1f", got[torch.float32], want[jnp.float32],
                 got[torch.bfloat16], want[jnp.bfloat16])
    # the GELU was really removed: K1f's own output differs
    monkeypatch.undo()
    assert not np.allclose(got[torch.float32], np.asarray(JM.mlp_block_reference(
        jnp.asarray(x), s, b, w1.T, b1, w2.T, b2), np.float32), atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_all_off_is_the_production_backward_bit_for_bit(dtype):
    B, N, D, H = SHAPE
    x, *p, do = (torch.from_numpy(a) for a in _inputs(B, N, D, seed=21))
    x, do = x.to(dtype), do.to(dtype)
    before = TX.LAUNCHES.count
    for g, w in zip(TX.attention_block_bwd_ablate(x, *p, H, do),
                    TA.attention_block_bwd_reference(x, *p, H, do)):
        assert torch.equal(g, w)
    assert TX.LAUNCHES.count == before  # CPU tensors launch nothing


@pytest.mark.parametrize("variant,code", [
    ("baseline", 0), ("no-softmax-vpu", 1), ("no-ds-vpu", 2), ("no-ln-bwd", 0),
    ("no-dw-matmuls", 0), ("no-core-matmuls", 4), ("no-mha-recompute", 8),
    ("softmax+ds off", 3)])
def test_core_codes(variant, code):
    assert TX.core_code(**dict(TX.VARIANTS)[variant]) == code


def test_other_flag_sets_raise():
    with pytest.raises(ValueError, match="one core flag"):
        TX.core_code(skip_core_mm=True, skip_ds=True)
    with pytest.raises(TypeError, match="flags"):
        TX.core_code(skip_gelu=True)


@pytest.mark.parametrize("B,N,D,H,takes", [
    (2048, 64, 384, 6, True), (3, 16, 128, 2, True), (2048, 64, 768, 12, True),
    (8, 48, 1344, 21, True), (8, 112, 384, 6, False), (8, 256, 384, 6, False),
    (8, 40, 384, 6, False), (8, 64, 96, 2, False), (8, 64, 1536, 24, False),
    (8, 64, 1152, 16, False), (8, 64, 384, 5, False), (0, 64, 384, 6, False)])
def test_gate_table(B, N, D, H, takes):
    assert TX.ablate_takes(B, N, D, H) is takes


@pytest.mark.parametrize("B,N,D,H", [(2, 256, 384, 6), (2, 128, 384, 6), (2, 64, 1536, 24)])
def test_refusals_name_roadmap_item_14(B, N, D, H):
    x, *p, do = (torch.from_numpy(a) for a in _inputs(B, N, D, seed=3))
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 14"):
        TX.attention_block_bwd_ablate(x, *p, H, do, skip_ds=True)
