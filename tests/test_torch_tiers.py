"""The port's kernel tier ladder (``ddm_tpu_torch/ops/tiers.py``) against the
JAX package's gates and dispatchers.

Each JAX dispatcher (``fused_attention_block``, ``fused_mlp_block``,
``expert_ffn_auto``) runs with ``DDM_TPU_PALLAS_INTERPRET=1`` (so
``kernels_enabled()`` holds, as on the TPU) on shape-only stand-ins, with its
tier functions replaced by markers, so that the test reads which tier it
takes without running it. The port's choosers must give the same answer on
a grid of shapes, and their private helpers must equal the JAX ones value
for value. The production answers are pinned, and the models that
``build_model`` makes from the DiT-S, DiT-B and DiT-L configs are shown to
reach them.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.expert_ffn as JX  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu_torch.models.factory import build_model  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.ops.moe_dispatch import moe_cfg  # noqa: E402
from ddm_tpu_torch.utils.config import load_yaml_config  # noqa: E402

WIDTHS = [128, 256, 384, 512, 768, 1024, 1152]
IMAGES = [16, 64, 256, 2048]  # B * m
TOKENS = [16, 64, 256]
ROWS = [64, 4096, 131072]


@pytest.fixture()
def jax_gates(monkeypatch):
    """The JAX dispatchers with markers in place of their tiers."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    for hatch in ("DDM_TPU_ATTN_BWD_BI", "DDM_TPU_MLP_VMEM_MB", "DDM_TPU_MLP_ROW_BLOCK"):
        monkeypatch.delenv(hatch, raising=False)
    monkeypatch.setattr(JA, "_fused_block", lambda *a: "fused")
    monkeypatch.setattr(JA, "_fused_block_sb", lambda *a: "split")
    monkeypatch.setattr(JA, "attention_block_reference", lambda *a, **k: None)
    monkeypatch.setattr(JM, "_fused", lambda *a: ("fused", 1))
    monkeypatch.setattr(JM, "_fused_fwdonly", lambda *a: ("fwdonly", 1))
    monkeypatch.setattr(JM, "_fused_fwdonly_fchunked", lambda x, s, b, w1, *a: (
        "fchunked", JM._mlp_fwd_fchunks(x.shape[0], x.shape[1], w1.shape[1])))
    monkeypatch.setattr(JM, "mlp_block_reference", lambda *a, **k: None)
    monkeypatch.setattr(JX, "expert_ffn", lambda *a: ("fused", 1))
    monkeypatch.setattr(JX, "_expert_ffn_fwdonly", lambda x, w1, *a: (
        "fwdonly", JX._expert_fwd_fchunks(x.shape[1], x.shape[2], w1.shape[2])))
    monkeypatch.setattr(JX, "expert_ffn_reference", lambda *a, **k: None)


def _shaped(*shape):
    return SimpleNamespace(shape=shape, dtype=None)


def jax_attention_tier(B, N, D, H):
    return JA.fused_attention_block(_shaped(B, N, D), None, None, None, None, None, None, H)


def jax_mlp_tier(T, D, F):
    return JM.fused_mlp_block(_shaped(T, D), None, None, _shaped(D, F), None, _shaped(F, D),
                              None)


def jax_expert_tier(E, S, D, F):
    return JX.expert_ffn_auto(_shaped(E, S, D), _shaped(E, D, F), None, _shaped(E, F, D), None)


@pytest.mark.parametrize("D", WIDTHS)
def test_attention_tier_matches_jax(jax_gates, D):
    H = D // 64
    for B in IMAGES:
        for N in TOKENS:
            shape = (B, N, D, H)
            assert tiers.attention_tier(*shape) == jax_attention_tier(*shape), shape
            assert tiers._choose_blocks(B, N, D) == JA._choose_blocks(B, N, D), shape
            g = JA._attn_pack(*shape)
            assert tiers._attn_pack(*shape) == g, shape
            for gg in {g, 1, 2, 4} - {0}:  # 0: no pack fits, nothing to size
                assert tiers._fwd_block_images(B, N, D, gg) == JA._fwd_block_images(B, N, D, gg)
                assert (tiers._bwd_block_images(B, N, D, gg, H)
                        == JA._bwd_block_images(B, N, D, gg, H)), (shape, gg)
                assert (tiers._bwd_split_block_images(B, N, D, gg, H)
                        == JA._bwd_split_block_images(B, N, D, gg, H)), (shape, gg)


@pytest.mark.parametrize("D", WIDTHS)
def test_mlp_tier_matches_jax(jax_gates, D):
    F = 4 * D
    for T in ROWS:
        assert tiers.mlp_tier(T, D, F) == jax_mlp_tier(T, D, F), (T, D)
        for fixed in (None, tiers._fwd_fixed(D, F)):
            assert tiers._row_block(T, D, F, fixed) == JM._row_block(T, D, F, fixed)
        assert tiers._mlp_kernel_ok(T, D, F) == JM._mlp_kernel_ok(T, D, F)
        assert tiers._mlp_fwd_kernel_ok(T, D, F) == JM._mlp_fwd_kernel_ok(T, D, F)
        assert tiers._mlp_fwd_fchunks(T, D, F) == JM._mlp_fwd_fchunks(T, D, F)
    assert (tiers._bwd_budget(), tiers._fwd_budget()) == (JM._bwd_budget(), JM._fwd_budget())


@pytest.mark.parametrize("D", WIDTHS)
def test_expert_tier_matches_jax(jax_gates, D):
    E, F = 8, 4 * D
    for T in ROWS:
        cfg, T_pad = moe_cfg(T, E, 256, 1.25, 1)
        S = T_pad // cfg.gs * cfg.cpad
        assert tiers.expert_tier(E, S, D, F) == jax_expert_tier(E, S, D, F), (S, D)
        assert tiers._expert_ffn_ok(E, S, D, F) == JX.expert_ffn_ok(E, S, D, F)
        assert tiers._expert_ffn_fwd_ok(E, S, D, F) == JX.expert_ffn_fwd_ok(E, S, D, F)
        assert tiers._expert_fwd_fchunks(S, D, F) == JX._expert_fwd_fchunks(S, D, F)


def test_ladders_fall_through_where_jax_runs_its_reference(jax_gates):
    """D = 64 (the CPU tests' tiny models) has no tier in either package:
    the JAX package runs its jnp/XLA reference, and the port its plain MLP
    and expert FFN on any device; the attention half-block takes the
    ladder's third rung, whose core at D = 64 (not a multiple of 128) is
    XLA's attention in JAX and the plain core in the port."""
    assert tiers.attention_tier(8, 16, 64, 2) is None is jax_attention_tier(8, 16, 64, 2)
    assert tiers.mlp_tier(128, 64, 256) is None is jax_mlp_tier(128, 64, 256)
    assert tiers.expert_tier(4, 64, 64, 256) is None is jax_expert_tier(4, 64, 64, 256)
    assert tiers.core_tier(8, 16, 64, 2) is None
    assert tiers.core_tier(8, 16, 128, 2) == "K7"  # D = 128: K7's gate holds


@pytest.mark.parametrize("which", ["mlp", "expert"])
def test_plain_versions_run_on_the_card_where_jax_has_no_tier(jax_gates, monkeypatch, which):
    """Where the JAX ladder has no MLP or expert-FFN tier it runs its jnp
    reference, so the port's Function takes its plain versions there on
    CUDA tensors too (stood in for by ``uses_kernel`` answering True):
    forward and backward, no launch and no kernel build. Where JAX has a
    tier, the same call goes to the kernel."""
    import ddm_tpu_torch.ops.expert_ffn as TX
    import ddm_tpu_torch.ops.mlp_block as TM

    r = np.random.default_rng(0)

    def arrays(*shapes):
        return [torch.from_numpy(r.standard_normal(s).astype(np.float32)) for s in shapes]

    def run(D):
        F = 4 * D
        if which == "mlp":
            module, T = TM, 128
            assert (tiers.mlp_tier(T, D, F) is None) == (jax_mlp_tier(T, D, F) is None)
            args = arrays((T, D), (D,), (D,), (F, D), (F,), (D, F), (D,))
            fn, ref, bwd = TM.fused_mlp_block, TM.mlp_block_reference, TM.mlp_block_bwd_reference
            counters = (TM.LAUNCHES, TM.BWD_LAUNCHES, TM.PARTIAL_LAUNCHES)
        else:
            module, E, S = TX, 4, 64
            assert (tiers.expert_tier(E, S, D, F) is None) == (
                jax_expert_tier(E, S, D, F) is None)
            args = arrays((E, S, D), (E, D, F), (E, F), (E, F, D), (E, D))
            fn, ref, bwd = TX.expert_ffn, TX.expert_ffn_reference, TX.expert_ffn_bwd_reference
            counters = (TX.LAUNCHES, TX.BWD_LAUNCHES, TX.PARTIAL_LAUNCHES)
        args[0] = args[0].to(torch.bfloat16)
        monkeypatch.setattr(module, "uses_kernel", lambda *t: True)
        before = [c.count for c in counters]
        leaves = [a.clone().requires_grad_() for a in args]
        out = fn(*leaves)
        dout = torch.ones_like(out)
        out.backward(dout)
        assert torch.equal(out, ref(*args))
        for leaf, w in zip(leaves, bwd(*args, dout)):
            assert torch.equal(leaf.grad, w.to(leaf.dtype))
        assert [c.count for c in counters] == before

    run(64)  # no tier in either package: the plain versions

    def kernel(*a):
        raise LookupError("the kernel path")

    monkeypatch.setattr(TM, "_k1f", kernel)
    monkeypatch.setattr(TX, "_k10f", kernel)
    with pytest.raises(LookupError, match="the kernel path"):
        run(128)  # a tier in both: the kernels


# (B * m, D, H, F): the training and sampling shapes of the three widths
PRODUCTION = [
    # DiT-S (configs/cifar10_dit.yaml): K2b, fused MLP, K10f
    (2048, 384, 6, "fused", ("fused", 1), ("fused", 1)),
    (64, 384, 6, "fused", ("fused", 1), ("fused", 1)),
    (256, 384, 6, "fused", ("fused", 1), ("fused", 1)),
    # DiT-B (configs/cifar10_dit_b.yaml): K4, fwd-only MLP, K10p k = 2
    (2048, 768, 12, "split", ("fwdonly", 1), ("fwdonly", 2)),
    (64, 768, 12, "split", ("fwdonly", 1), ("fwdonly", 2)),
    # DiT-L (configs/cifar10_dit_l.yaml): K4, F-chunked MLP k = 2, K10p k = 4
    (2048, 1024, 16, "split", ("fchunked", 2), ("fwdonly", 4)),
    (64, 1024, 16, "split", ("fchunked", 2), ("fwdonly", 4)),
    # DiT-XL/4 (D 1152, 16 heads of Dh 72): K4, F-chunked MLP k = 2, K10p k = 4
    (2048, 1152, 16, "split", ("fchunked", 2), ("fwdonly", 4)),
    (256, 1152, 16, "split", ("fchunked", 2), ("fwdonly", 4)),
    # DiT-S at --heads 16 (Dh 24): K2b, fused MLP, K10f
    (2048, 384, 16, "fused", ("fused", 1), ("fused", 1)),
]


@pytest.mark.parametrize("images,D,H,attn,mlp,expert", PRODUCTION)
def test_production_tiers_are_pinned(jax_gates, images, D, H, attn, mlp, expert):
    N = 64
    T = images * N
    cfg, T_pad = moe_cfg(T, 8, 256, 1.25, 1)
    S = T_pad // cfg.gs * cfg.cpad
    assert tiers.attention_tier(images, N, D, H) == attn == jax_attention_tier(images, N, D, H)
    assert tiers.mlp_tier(T, D, 4 * D) == mlp == jax_mlp_tier(T, D, 4 * D)
    assert tiers.expert_tier(8, S, D, 4 * D) == expert == jax_expert_tier(8, S, D, 4 * D)
    if D == 1024:  # the pack the half-block kernels use at DiT-L width
        assert tiers._attn_pack(images, N, D, H) == 2


@pytest.fixture()
def jax_core_gates(monkeypatch):
    """JAX's ``fused_attention`` with markers in place of its three cores."""
    import ddm_tpu.ops.flash as JF

    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JA, "_fused_attention", lambda *a: "K7")
    monkeypatch.setattr(JF, "flash_attention_streaming", lambda *a: "K8")
    monkeypatch.setattr(JA, "attention_reference", lambda *a: None)


# (B, N, D, H, half-block tier, core): DiT-XL/4 at 32 px (256 x m 8) and 64
# px (64 x m 4), DiT-S at --heads 24 (Dh 16) and --heads 16 (Dh 24), D 1536
# (the first width past the port's half-block GEMMs), Dh 36 (no kernel)
HEAD_WIDTHS = [
    (2048, 64, 1152, 16, "split", "K7"), (64, 256, 1152, 16, None, "K7"),
    (2048, 64, 384, 24, "split", "K7"), (8, 64, 384, 16, "fused", "K7"),
    (2048, 64, 1536, 16, None, "K7"), (2048, 64, 1152, 32, None, None),
]


@pytest.mark.parametrize("B,N,D,H,attn,core", HEAD_WIDTHS)
def test_head_width_ladder_matches_jax(jax_gates, jax_core_gates, B, N, D, H, attn, core):
    """At head widths off 64 and D past 1024 the port's ladder takes JAX's
    half-block tier and, where there is none, JAX's core."""
    assert tiers.attention_tier(B, N, D, H) == attn == jax_attention_tier(B, N, D, H)
    t = SimpleNamespace(shape=(B, N, D))
    assert tiers.core_tier(B, N, D, H) == core == JA.fused_attention(t, t, t, H)


@pytest.mark.parametrize("config,attn,mlp,expert", [
    ("cifar10_dit.yaml", "fused", ("fused", 1), ("fused", 1)),
    ("cifar10_dit_b.yaml", "split", ("fwdonly", 1), ("fwdonly", 2)),
    ("cifar10_dit_l.yaml", "split", ("fchunked", 2), ("fwdonly", 4)),
])
def test_build_model_reaches_each_configs_tiers(config, attn, mlp, expert):
    """The model build_model makes from each config's widths (on the meta
    device: no memory) meets at its recipe's training shape (batch 256 x
    m 8 = 2048 images of N = 64 tokens) the tiers pinned above: K2b and the
    fused MLP at D 384; K4, then fwd-only or F-chunked, and K10p at 768 and
    1024. The MoE model takes the recipe of cifar10_dit_moe.yaml."""
    yaml = load_yaml_config(str(Path(__file__).resolve().parents[1] / "configs" / config))
    keys = ("image_size", "patch_size", "embed_dim", "depth", "heads", "mlp_ratio")
    base = {k: yaml[k] for k in keys}
    dense = build_model({**base, "depth": 1}, "meta")
    moe = build_model({**base, "depth": 1, "moe_experts": 8, "moe_group_size": 256,
                       "moe_capacity": 1.25}, "meta")
    images = yaml["batch"] * yaml["m"]
    N, D = dense.num_patches, dense.embed_dim
    block = dense.blocks[0]
    F = block.ff.net["0"].weight.shape[0]
    assert tiers.attention_tier(images, N, D, block.num_heads) == attn
    assert tiers.mlp_tier(images * N, D, F) == mlp
    layer = moe.blocks[0].moe
    cfg, T_pad = moe_cfg(images * N, layer.num_experts, layer.group_size, layer.capacity,
                         layer.topk)
    E, D_in, F_e = layer.experts_in.shape
    assert tiers.expert_tier(E, T_pad // cfg.gs * cfg.cpad, D_in, F_e) == expert
