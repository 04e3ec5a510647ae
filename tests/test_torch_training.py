"""Parity of the port's training slice with the JAX package: the whole DiT
loss and every parameter gradient, the optax clip + AdamW step, the
augmentation, the synthetic loader, the config merge and the gradient map.

The DiT test rebuilds the JAX loss from ``forward_marginal_sample`` +
``apply(..., method="tokens")`` + ``fused_energy_terms`` with the same
injected t, eps and xi (keys cannot match across frameworks), with the JAX
Pallas kernels in interpret mode and their plain versions made to raise;
the port runs ``distributional_training_step`` on CPU tensors (its plain
versions) and ``backward()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.energy as JE  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu.data.augment import augment_cifar10 as jax_augment  # noqa: E402
from ddm_tpu.data.cifar10 import CIFAR10DataConfig as JaxDataConfig  # noqa: E402
from ddm_tpu.data.cifar10 import build_cifar10_dataloaders as jax_loaders  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
from ddm_tpu_torch.data.augment import augment_cifar10, normalize_images  # noqa: E402
from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig, build_cifar10_dataloaders  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, patchify_images  # noqa: E402
from ddm_tpu_torch.training import (  # noqa: E402
    clip_grads_by_global_norm_,
    distributional_training_step,
    make_optimizer,
    make_train_step,
    split_generator,
)
from ddm_tpu_torch.utils.config import apply_config  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

CFG = dict(img=16, patch=4, dim=128, depth=2, heads=2, tdim=32)
B, M, BETA, LAM, W_BIAS = 2, 4, 0.1, 1.0, 0.0


def _boom(*a, **k):
    raise AssertionError("JAX took a plain version, not its Pallas kernel")


def _kernels_only(mp):
    """Pallas in interpret mode; the JAX plain versions raise if reached."""
    mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    for mod, name in ((JM, "mlp_block_reference"), (JA, "attention_block_reference"),
                      (JE, "_jnp_energy_terms")):
        mp.setattr(mod, name, _boom)


def _jax_model(dtype):
    return JaxDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                  depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                  dtype=dtype, data_format="NHWC")


def _jax_variables(seed=0):
    x0 = jnp.zeros((1, CFG["img"], CFG["img"], 3))
    variables = _jax_model(jnp.float32).init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)), x0)
    r = np.random.default_rng(seed)  # non-trivial LN params and biases
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32),
        variables)


def _step_inputs(seed=1):
    r = np.random.default_rng(seed)
    shape = (B, CFG["img"], CFG["img"], 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_loss_and_grads(variables, inputs, dtype):
    model = _jax_model(dtype)
    x0, t, eps, xi = inputs

    def loss_fn(params):
        xt = jax_marginal(x0, t, eps)
        xt_rep = jnp.repeat(xt, M, axis=0)
        out = model.apply({"params": params}, xt_rep, jnp.repeat(t, M),
                          xi.reshape((B * M,) + x0.shape[1:]), method="tokens")
        target = jax_patchify(x0, CFG["patch"]).reshape(B, -1)
        conf, inter = JE.fused_energy_terms(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=W_BIAS))
        return weight * (conf - (LAM / (2.0 * (M - 1))) * inter)

    loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    return float(loss), {jax.tree_util.keystr(p): np.asarray(g, np.float32)
                         for p, g in jax.tree_util.tree_leaves_with_path(grads)}


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX loss and gradients of one step in fp32 and bf16, through its
    Pallas kernels (interpret mode), on shared weights and injected noise."""
    assert JE._kernel_supported(B, M, CFG["img"] ** 2 * 3)  # the JAX K3 path
    variables, inputs = _jax_variables(), _step_inputs()
    with pytest.MonkeyPatch.context() as mp:
        _kernels_only(mp)
        return variables, inputs, {name: _jax_loss_and_grads(variables, inputs, dtype)
                                   for name, dtype in (("float32", jnp.float32),
                                                       ("bfloat16", jnp.bfloat16))}


def _port_loss_and_grads(variables, inputs, dtype):
    model = DDDMDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                    depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                    dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]))
    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    loss, metrics = distributional_training_step(
        model.tokens, x0, m=M, beta=BETA, lam=LAM, w_bias=W_BIAS, t=t, eps=eps, xi=xi,
        target_transform=lambda a: patchify_images(a, CFG["patch"]))
    loss.backward()
    assert set(metrics) == {"loss", "confidence", "interaction", "weight"}
    named = dict(model.named_parameters())
    for name, p in named.items():  # pos_embed and the permuted patch weight included
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=CFG["patch"])["params"]
    grads = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}
    assert len(grads) == len(named)
    return float(loss.detach()), grads


def test_dit_training_loss_and_every_gradient_match_jax(jax_reference):
    variables, inputs, ref = jax_reference
    want_loss, want = ref["float32"]
    loss, got = _port_loss_and_grads(variables, inputs, torch.float32)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for path, w in want.items():
        # fp32 sums of B*m*N rows taken in another order: the kernel tests'
        # 1e-4 relative, absolute part scaled by the leaf's largest entry
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=path)


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_dit_bf16_gradients_lie_within_bf16_noise_of_jax(jax_reference):
    """bf16 rounds at other places in the two frameworks (XLA may keep excess
    precision across the embed's bf16 adds, the port rounds each), so each
    bf16 gradient is held to bf16's own noise on this step: it lies within
    2 e of JAX's bf16 gradient, e = |JAX bf16 - JAX fp32| (relative
    Frobenius). The loss, a mean over B*m*N*C terms, stays within 1e-4 of
    JAX's, some 40x under one bf16 unit at its size."""
    variables, inputs, ref = jax_reference
    loss32, want32 = ref["float32"]
    loss16, want16 = ref["bfloat16"]
    loss, got = _port_loss_and_grads(variables, inputs, torch.bfloat16)
    assert abs(loss - loss16) <= 1e-4 * abs(loss32)
    for path, w in want16.items():
        noise = _rel_frob(w, want32[path])
        assert 0 < noise < 0.1, path
        assert _rel_frob(got[path], w) <= 2 * noise, path


def test_gradient_map_inverts_state_dict_from_jax():
    variables = _jax_variables(seed=3)
    back = jax_tree_from_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]),
                                    patch_size=CFG["patch"])
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(got)
    for path, v in leaves:
        np.testing.assert_array_equal(got[path], v, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("norm", [3.0, 0.5])
def test_clip_and_adamw_step_match_optax(norm):
    """Two steps of clip(1.0) + AdamW(1e-4, wd 0.01) from the same params and
    grads, with the global norm above 1 (clipped) and below (left alone)."""
    r = np.random.default_rng(4)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: r.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    total = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    grads = {k: (g * (norm / total)).astype(np.float32) for k, g in grads.items()}

    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-4, weight_decay=0.01))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for _ in range(2):
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), lr=1e-4, weight_decay=0.01)
    for _ in range(2):
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        got_norm = clip_grads_by_global_norm_(tp.values(), 1.0)
        opt.step()
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-5)
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_clip_follows_optax_not_clip_grad_norm():
    """optax leaves gradients alone below the max and scales by max/norm at
    or above it; torch's clip_grad_norm_ scales by max/(norm + 1e-6)."""
    g = torch.tensor([3.0, 4.0])  # norm 5
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = g.clone()
    clip_grads_by_global_norm_([p], 1.0)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(optax.clip_by_global_norm(1.0).update(
        jnp.asarray(g.numpy()), None)[0]), rtol=0, atol=0)
    p.grad = g.clone()
    clip_grads_by_global_norm_([p], 5.5)
    assert torch.equal(p.grad, g)


def test_augmentation_matches_jax_with_its_draws_injected():
    r = np.random.default_rng(5)
    images = r.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_augment(key, jnp.asarray(images)))
    # the JAX function's own draws (augment.py:48-63), fed to the port
    kc, kf = jax.random.split(key)
    offsets = np.array(jax.random.randint(kc, (6, 2), 0, 9))
    flips = np.array(jax.random.bernoulli(kf, 0.5, (6,)))
    got = augment_cifar10(torch.from_numpy(images), offsets=torch.from_numpy(offsets),
                          flips=torch.from_numpy(flips)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(normalize_images(torch.from_numpy(images)).numpy(),
                                  images.astype(np.float32) / 127.5 - 1.0)
    drawn = augment_cifar10(torch.from_numpy(images), torch.Generator().manual_seed(0))
    assert drawn.shape == (6, 32, 32, 3) and drawn.dtype == torch.float32
    assert float(drawn.min()) >= -1.0 and float(drawn.max()) <= 1.0


def test_synthetic_loader_matches_jax():
    ours, ours_eval = build_cifar10_dataloaders(
        CIFAR10DataConfig(batch_size=100, synthetic=True, synthetic_size=300, seed=3))
    theirs, theirs_eval = jax_loaders(
        JaxDataConfig(batch_size=100, synthetic=True, synthetic_size=300, seed=3))
    assert len(ours) == len(theirs) == 3
    for epoch in (1, 4):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for (a, la), (b, lb) in zip(ours, theirs):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(next(iter(ours_eval))[0], next(iter(theirs_eval))[0])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_cifar10_dataloaders(CIFAR10DataConfig(synthetic=False))


def test_apply_config_fills_only_defaults(tmp_path):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--config")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=10)
    cfg = tmp_path / "c.yaml"
    cfg.write_text("lr: 0.5\nepochs: 3\n")
    args = p.parse_args(["--config", str(cfg), "--epochs", "7"])
    apply_config(p, args)
    assert (args.lr, args.epochs) == (0.5, 7)
    cfg.write_text("nope: 1\n")
    with pytest.raises(ValueError, match="nope"):
        apply_config(p, p.parse_args(["--config", str(cfg)]))


def test_train_step_updates_in_place_and_is_seeded():
    """make_train_step: the same generator seed gives the same update, and
    the parameters move."""
    def run(seed):
        torch.manual_seed(0)
        model = DDDMDiT(img_size=16, patch_size=4, embed_dim=64, depth=1, num_heads=2,
                        time_embed_dim=16)
        from ddm_tpu_torch.models.dit import init_params

        init_params(model, torch.Generator().manual_seed(0))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model.parameters(), 1e-3, 0.01)
        step = make_train_step(model, model.tokens, opt, m=2, beta=BETA, lam=LAM,
                               w_bias=W_BIAS, grad_clip=1.0,
                               preprocess=lambda b, g: augment_cifar10(b, g),
                               target_transform=lambda a: patchify_images(a, 4))
        images = torch.from_numpy(np.random.default_rng(6).integers(
            0, 256, (3, 16, 16, 3), dtype=np.uint8))
        metrics = step(images, torch.Generator().manual_seed(seed))
        return metrics, before, model.state_dict()

    m1, before, after = run(11)
    m2, _, after2 = run(11)
    m3, _, _ = run(12)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert not torch.equal(m1["loss"], m3["loss"])
    assert all(torch.equal(after[k], after2[k]) for k in after)
    assert any(not torch.equal(after[k], before[k]) for k in after)
    gens = split_generator(torch.Generator().manual_seed(0), 2)
    assert gens[0].initial_seed() != gens[1].initial_seed()
