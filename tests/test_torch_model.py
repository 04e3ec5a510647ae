"""Parity of the PyTorch port's DiT, factory, converter, checkpoints and PNG
writer with the JAX package.

A tiny DiT (img 16, patch 4 -> N = 16 tokens, D = 128, depth 2, 2 heads,
time-embed 32) is initialised by the JAX package, moved into the port with
``state_dict_from_jax``, and both forwards run on the same numpy inputs:
the JAX side through its Pallas kernels in interpret mode (its plain
half-block versions raise if reached), the port on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.models.factory as JF  # noqa: E402
import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.models.dit import sinusoidal_time_embedding as jax_temb  # noqa: E402
from ddm_tpu.utils.convert import (  # noqa: E402
    reference_state_dict_from_dit,
    save_reference_checkpoint,
)
from ddm_tpu_torch.models import factory as TF  # noqa: E402
from ddm_tpu_torch.models.dit import (  # noqa: E402
    DDDMDiT,
    init_params,
    patchify_images,
    sinusoidal_time_embedding,
)
from ddm_tpu_torch.utils.checkpoint import load_params, save_checkpoint  # noqa: E402
from ddm_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from ddm_tpu_torch.utils.plotting import save_image_grid  # noqa: E402

CFG = dict(img=16, patch=4, dim=128, depth=2, heads=2, tdim=32)
B = 8


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain version, not the Pallas kernel")

    monkeypatch.setattr(JM, "mlp_block_reference", boom)
    monkeypatch.setattr(JA, "attention_block_reference", boom)


def _jax_model(dtype):
    return JaxDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                  depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                  dtype=dtype, data_format="NHWC")


def _jax_variables(seed=0):
    x0 = jnp.zeros((1, CFG["img"], CFG["img"], 3))
    variables = _jax_model(jnp.float32).init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)), x0)
    # non-trivial LN params and biases (flax initialises them to 1 / 0)
    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32),
        variables)


def _port_model(variables, dtype):
    model = DDDMDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                    depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                    dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]))
    return model.eval()


def _inputs(seed=1):
    r = np.random.default_rng(seed)
    shape = (B, CFG["img"], CFG["img"], 3)
    return (r.standard_normal(shape).astype(np.float32),
            r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


# fp32: two blocks of half-blocks, each at the kernel tests' 1e-4/1e-5, plus
# the final LayerNorm (flax computes its variance as E[x^2] - E[x]^2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _forwards(dtype_name, variables, xt, t, xi):
    want = np.asarray(_jax_model(getattr(jnp, dtype_name)).apply(variables, xt, t, xi))
    with torch.inference_mode():
        got = _port_model(variables, getattr(torch, dtype_name))(
            torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(xi))
    assert got.dtype == torch.float32 and got.shape == want.shape
    return got.numpy(), want


def test_dit_forward_matches_jax_fp32(jax_kernels_only):
    got, want = _forwards("float32", _jax_variables(), *_inputs())
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_dit_forward_matches_jax_bf16(jax_kernels_only):
    """bf16 roundings differ between the two libraries (XLA may keep excess
    precision across the embed's bf16 adds; the port rounds each), so the
    tolerance is bf16's own noise on this model: e = |JAX bf16 - JAX fp32|.
    The port's bf16 forward must lie within 2e of JAX's bf16 forward (max
    and mean) and within 2e of the fp32 forward."""
    variables, (xt, t, xi) = _jax_variables(), _inputs()
    got, want = _forwards("bfloat16", variables, xt, t, xi)
    want32 = np.asarray(_jax_model(jnp.float32).apply(variables, xt, t, xi))
    noise = np.abs(want - want32)
    assert 0 < noise.max() < 0.25  # bf16 noise is real and small
    d = np.abs(got - want)
    assert d.max() <= 2 * noise.max() and d.mean() <= 2 * noise.mean()
    assert np.abs(got - want32).max() <= 2 * noise.max()


def test_dit_tokens_match_jax(jax_kernels_only):
    variables = _jax_variables(seed=2)
    xt, t, xi = _inputs(seed=3)
    want = np.asarray(_jax_model(jnp.float32).apply(variables, xt, t, xi, method="tokens"))
    with torch.inference_mode():
        got = _port_model(variables, torch.float32).tokens(
            torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(xi))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_patchify_and_time_embedding_match_jax():
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 8, 8, 6)).astype(np.float32)
    np.testing.assert_array_equal(patchify_images(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jax_patchify(x, 4)))
    t = r.uniform(0, 1, 5).astype(np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            sinusoidal_time_embedding(torch.from_numpy(t), dim).numpy(),
            np.asarray(jax_temb(jnp.asarray(t), dim)), rtol=1e-6, atol=1e-6)


def test_state_dict_from_jax_equals_reference_converter():
    variables = _jax_variables()
    want = reference_state_dict_from_dit(variables, patch_size=CFG["patch"])
    got = state_dict_from_jax(variables, patch_size=CFG["patch"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(got) == set(_port_model(variables, torch.float32).state_dict())

    # a tp>1 tree's separate q/k/v re-fuse to the same rows
    p = jax.tree.map(lambda a: a, variables)
    for i in range(CFG["depth"]):
        attn = p["params"][f"block_{i}"]["attn"]
        wq, wk, wv = np.split(attn["qkv"]["kernel"], 3, axis=1)
        bq, bk, bv = np.split(attn["qkv"]["bias"], 3)
        p["params"][f"block_{i}"]["attn"] = {
            "q": {"kernel": wq, "bias": bq}, "k": {"kernel": wk, "bias": bk},
            "v": {"kernel": wv, "bias": bv}, "proj": attn["proj"]}
    split = state_dict_from_jax(p, patch_size=CFG["patch"])
    for k in want:
        np.testing.assert_array_equal(split[k].numpy(), want[k], err_msg=k)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """The ``.pt`` that ``save_reference_checkpoint`` (and hence
    ``convert_reference_ckpt.py --to-torch``) writes loads with the port's
    ``load_params`` and drives the same forward."""
    variables = _jax_variables(seed=5)
    config = {"image_size": CFG["img"], "patch_size": CFG["patch"],
              "embed_dim": CFG["dim"], "depth": CFG["depth"], "heads": CFG["heads"],
              "time_embed": CFG["tdim"], "dtype": "float32"}
    path = tmp_path / "model.pt"
    save_reference_checkpoint(str(path), variables, config)
    sd, cfg = load_params(str(path))
    assert cfg == config
    model = TF.build_model(cfg)
    model.load_state_dict(sd)
    direct = _port_model(variables, torch.float32)
    xt, t, xi = (torch.from_numpy(a) for a in _inputs(seed=6))
    with torch.inference_mode():
        torch.testing.assert_close(model(xt, t, xi), direct(xt, t, xi), rtol=0, atol=0)

    # the port's own writer round-trips
    save_checkpoint(str(tmp_path / "again.pt"), model.state_dict(), cfg)
    sd2, cfg2 = load_params(str(tmp_path / "again.pt"))
    assert cfg2 == cfg and all(torch.equal(sd2[k], sd[k]) for k in sd)


def test_factory_defaults_match_jax():
    assert TF.MODEL_DEFAULTS == JF.MODEL_DEFAULTS
    assert TF.SAMPLER_DEFAULTS == JF.SAMPLER_DEFAULTS
    model = TF.build_model({}, device="meta")
    assert (model.embed_dim, len(model.blocks), model.num_patches) == (384, 8, 64)
    assert model.dtype == torch.bfloat16
    assert model.blocks[0].ff.net["0"].weight.shape == (1536, 384)


_REFUSED = [
    ({"tp": 2, "sp": True}, "item 11"), ({"sp": True}, "item 11"),
    ({"moe_experts": 4, "tp": 2}, "item 11"),
    ({"remat": True}, "item 8"), ({"mlp_persist": 2}, "item 8"),
]


@pytest.mark.parametrize("cfg,item", _REFUSED, ids=[
    "-".join(f"{k}-{v}" for k, v in cfg.items()) + f"-{item}" for cfg, item in _REFUSED])
def test_factory_refuses_unported_keys(cfg, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        TF.build_model(cfg, device="meta")


def test_factory_builds_64_px_and_runs():
    """--image-size 64 (N = 256 tokens) builds and runs its forward."""
    cfg = {"image_size": 64, "embed_dim": 128, "depth": 1, "heads": 2, "time_embed": 32}
    model = init_params(TF.build_model(cfg), torch.Generator().manual_seed(3))
    r = np.random.default_rng(4)
    xt, xi = (torch.from_numpy(r.standard_normal((2, 64, 64, 3)).astype(np.float32))
              for _ in range(2))
    with torch.inference_mode():
        out = model(xt, torch.tensor([0.3, 0.8]), xi)
    assert model.num_patches == 256 and out.shape == (2, 64, 64, 3)
    assert torch.isfinite(out.float()).all()


def test_init_params_is_seeded_and_device_independent():
    cfg = {"image_size": 16, "embed_dim": 128, "depth": 1, "heads": 2, "time_embed": 32}
    a = init_params(TF.build_model(cfg), torch.Generator().manual_seed(7))
    b = init_params(TF.build_model(cfg), torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    sd = a.state_dict()
    assert torch.equal(sd["blocks.0.norm1.weight"], torch.ones(128))
    assert torch.equal(sd["blocks.0.attn.qkv.bias"], torch.zeros(384))
    assert 0.5 < float(sd["blocks.0.ff.net.0.weight"].std() * 128 ** 0.5) < 1.5


def _read_png(path):
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    ch = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    assert depth == 8 and (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, ch)


def test_image_grid_layout_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from ddm_tpu.utils.plotting import save_image_grid as jax_grid
    import matplotlib.pyplot as plt

    imgs = np.random.default_rng(8).uniform(-0.2, 1.2, (5, 6, 7, 3)).astype(np.float32)
    save_image_grid(imgs, str(tmp_path / "port.png"), nrow=3)
    jax_grid(imgs, str(tmp_path / "jax.png"), nrow=3)
    got = _read_png(tmp_path / "port.png").astype(np.int32)
    want = np.round(plt.imread(str(tmp_path / "jax.png"))[..., :3] * 255).astype(np.int32)
    assert got.shape == want.shape == (2 * 8 + 2, 3 * 9 + 2, 3)
    assert np.abs(got - want).max() <= 1
