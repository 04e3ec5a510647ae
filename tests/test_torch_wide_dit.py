"""The wide-width tiers through whole models: a depth-2 DiT and a depth-2
MoE DiT with the DiT-B/L tiers forced in both packages (the split attention
backward, the F-chunked MLP forward at k = 2, the expert FFN's F-chunked
partials at k = 2), their forwards and one training step's loss terms and
gradients against the JAX package's, whose kernels run in interpret mode;
flax's fan-in at DiT-L width; and the trainer and sampler CLIs at DiT-L
width on the CPU, where the real shapes choose the F-chunked tier.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.expert_ffn as JX  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
import ddm_tpu.ops.moe_dispatch as JD  # noqa: E402
import generate_torch  # noqa: E402
import train_cifar10_dit_torch as cli  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.models.factory import make_tokens_apply as jax_tokens_apply  # noqa: E402
from ddm_tpu.ops.energy import fused_energy_terms as jax_energy  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig  # noqa: E402
from ddm_tpu_torch.models import factory as TF  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, init_params, patchify_images  # noqa: E402
from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

CFG = dict(img=16, patch=4, dim=128, depth=2, heads=2, tdim=32)
MOE = dict(moe_experts=4, moe_capacity=1.25, moe_group_size=32, moe_topk=1)
B, M, BETA, LAM, W_BIAS, AUX_W = 2, 4, 0.1, 1.0, 0.0, 0.01
ROUTER_GAIN = 20.0  # a decisive router: bf16 rounding moves no token to another expert


@pytest.fixture()
def wide_tiers(monkeypatch):
    """The DiT-B/L tiers in both packages, whatever the shapes would pick,
    and counts of the port's chunked plain forwards."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JA, "_bwd_block_images", lambda *a: 0)  # leaves the split backward
    monkeypatch.setattr(JM, "_mlp_kernel_ok", lambda *a: False)
    monkeypatch.setattr(JM, "_mlp_fwd_kernel_ok", lambda *a: False)
    monkeypatch.setattr(JM, "_mlp_fwd_fchunks", lambda *a: 2)
    monkeypatch.setattr(JX, "expert_ffn_ok", lambda *a: False)
    monkeypatch.setattr(JX, "_expert_fwd_fchunks", lambda *a: 2)
    monkeypatch.setattr(JD, "moe_dispatch_ok", lambda *a: False)  # the einsum path around K10p

    def boom(*a, **k):
        raise AssertionError("JAX left its split attention half-block")

    monkeypatch.setattr(JA, "attention_block_reference", boom)
    jax_calls = {"K6f": 0, "K10p": 0}
    real_partial, real_chunked = JM._fused_partial_fwd_call, JX._fwd_call_chunked

    def partial(*a):
        jax_calls["K6f"] += 1
        return real_partial(*a)

    def chunked(*a):
        jax_calls["K10p"] += 1
        return real_chunked(*a)

    monkeypatch.setattr(JM, "_fused_partial_fwd_call", partial)
    monkeypatch.setattr(JX, "_fwd_call_chunked", chunked)

    monkeypatch.setattr(tiers, "attention_tier", lambda *a: "split")
    monkeypatch.setattr(tiers, "mlp_tier", lambda *a: ("fchunked", 2))
    monkeypatch.setattr(tiers, "expert_tier", lambda *a: ("fwdonly", 2))
    calls = {"mlp": 0, "expert": 0}
    real_mlp, real_ffn = TM.mlp_block_fchunked_reference, TX.expert_ffn_fchunked_reference

    def mlp(*a):
        calls["mlp"] += 1
        return real_mlp(*a)

    def ffn(*a):
        calls["expert"] += 1
        return real_ffn(*a)

    monkeypatch.setattr(TM, "mlp_block_fchunked_reference", mlp)
    monkeypatch.setattr(TX, "expert_ffn_fchunked_reference", ffn)
    return calls, jax_calls


def _jax_model(dtype, moe):
    return JaxDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                  depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                  dtype=dtype, data_format="NHWC", **(MOE if moe else {}))


def _variables(moe, seed=0):
    x0 = jnp.zeros((1, CFG["img"], CFG["img"], 3))
    variables = _jax_model(jnp.float32, moe).init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)),
                                                  x0)
    r = np.random.default_rng(seed)  # non-trivial LN params and biases
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)
    if moe:
        for i in range(CFG["depth"]):
            block = variables["params"][f"block_{i}"]["moe"]
            block["router_kernel"] = block["router_kernel"] * ROUTER_GAIN
    return variables


def _port_model(variables, dtype, moe):
    model = DDDMDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                    depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                    dtype=dtype, **(MOE if moe else {}))
    model.load_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]))
    return model


def _inputs(seed=1, n=8):
    r = np.random.default_rng(seed)
    shape = (n, CFG["img"], CFG["img"], 3)
    return (r.standard_normal(shape).astype(np.float32), r.uniform(0, 1, n).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_wide_tier_dit_forward_matches_jax(wide_tiers, moe):
    """fp32 to 1e-4; bf16 within bf16's own noise on this model, as
    tests/test_torch_model.py holds it: e = |JAX bf16 - JAX fp32|, the port's
    bf16 forward within 2e of JAX's (max and mean) and of the fp32 one."""
    calls, jax_calls = wide_tiers
    variables, (xt, t, xi) = _variables(moe), _inputs()
    want32 = np.asarray(_jax_model(jnp.float32, moe).apply(variables, xt, t, xi))
    want16 = np.asarray(_jax_model(jnp.bfloat16, moe).apply(variables, xt, t, xi))
    assert jax_calls["K10p" if moe else "K6f"] > 0  # JAX ran its chunked kernels
    args = (torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(xi))
    with torch.inference_mode():
        got32 = _port_model(variables, torch.float32, moe)(*args).numpy()
        got16 = _port_model(variables, torch.bfloat16, moe)(*args).numpy()
    assert calls["expert" if moe else "mlp"] == 2 * CFG["depth"]
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-4)
    noise = np.abs(want16 - want32)
    assert 0 < noise.max() < 0.5
    d = np.abs(got16 - want16)
    assert d.max() <= 2 * noise.max() and d.mean() <= 2 * noise.mean()
    assert np.abs(got16 - want32).max() <= 2 * noise.max()


def _step_inputs(seed=2):
    r = np.random.default_rng(seed)
    shape = (B, CFG["img"], CFG["img"], 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_step(variables, inputs, dtype, moe):
    model = _jax_model(dtype, moe)
    apply_fn = jax_tokens_apply(model, AUX_W) if moe else None
    x0, t, eps, xi = inputs

    def loss_fn(params):
        xt = jnp.repeat(jax_marginal(x0, t, eps), M, axis=0)
        args = (xt, jnp.repeat(t, M), xi.reshape((B * M,) + x0.shape[1:]))
        if moe:
            out, aux = apply_fn({"params": params}, *args)
        else:
            out, aux = model.apply({"params": params}, *args, method="tokens"), 0.0
        target = jax_patchify(x0, CFG["patch"]).reshape(B, -1)
        conf, inter = jax_energy(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=W_BIAS))
        loss = weight * (conf - (LAM / (2.0 * (M - 1))) * inter) + aux
        return loss, {"loss": loss, "confidence": conf, "interaction": inter, "moe_aux": aux}

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return ({k: float(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(p): np.asarray(g, np.float32)
             for p, g in jax.tree_util.tree_leaves_with_path(grads)})


def _port_step(variables, inputs, dtype, moe):
    model = _port_model(variables, dtype, moe)
    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    _, metrics = distributional_training_step(
        TF.make_tokens_apply(model, AUX_W), x0, m=M, beta=BETA, lam=LAM, w_bias=W_BIAS,
        t=t, eps=eps, xi=xi, target_transform=lambda a: patchify_images(a, CFG["patch"]))
    metrics["loss"].backward()
    named = dict(model.named_parameters())
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=CFG["patch"])["params"]
    grads = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}
    assert len(grads) == len(named)
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_wide_tier_training_step_matches_jax(wide_tiers, moe):
    """One step, B = 2 x m = 4 on 16-px images, injected t, eps, xi. fp32:
    the loss terms (and moe_aux) to 1e-4 relative, every gradient leaf to
    1e-4 with the absolute part at 1e-5 of its largest entry. bf16: the
    loss and each gradient within twice bf16's own noise on this step, e =
    |JAX bf16 - JAX fp32| (relative Frobenius for the gradients). In the
    wide tiers JAX's backward is XLA's autodiff, whose weight cotangents are
    bf16; the port's are fp32. In the MoE step the bf16 router sends some
    tokens to other experts than the fp32 one does (in JAX as in the port),
    so e reaches the order of the gradients upstream of block 1's router;
    the dense step's e stays under 10%."""
    calls, _ = wide_tiers
    variables, inputs = _variables(moe, seed=6), _step_inputs()
    keys = ("loss", "confidence", "interaction") + (("moe_aux",) if moe else ())
    want_m, want = _jax_step(variables, inputs, jnp.float32, moe)
    got_m, got = _port_step(variables, inputs, torch.float32, moe)
    assert calls["expert" if moe else "mlp"] == CFG["depth"]
    assert set(got) == set(want)
    for k in keys:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, err_msg=k)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=path)

    want16_m, want16 = _jax_step(variables, inputs, jnp.bfloat16, moe)
    got16_m, got16 = _port_step(variables, inputs, torch.bfloat16, moe)
    loss_noise = abs(want16_m["loss"] - want_m["loss"])
    assert 0 < loss_noise < 1e-2
    assert abs(got16_m["loss"] - want16_m["loss"]) <= 2 * loss_noise
    for path, w in want16.items():
        noise = _rel_frob(w, want[path])
        assert 0 < noise and (moe or noise < 0.1), path
        assert _rel_frob(got16[path], w) <= 2 * noise, path


def test_init_follows_flax_fan_in_at_dit_l_width():
    """flax's lecun_normal draws std 1/sqrt(fan_in) at D = 1024 as at 384:
    the qkv, projection, MLP and time weights (fan-in D or F = 4D), the
    patch embed (fan-in 6 p^2) and the expert leaves (fan-in E D, E F);
    within 3%."""
    D, Fh, E = 1024, 4096, 8
    dense = init_params(TF.build_model({"embed_dim": D, "heads": 16, "depth": 1}),
                        torch.Generator().manual_seed(0))
    moe = init_params(TF.build_model({"embed_dim": D, "heads": 16, "depth": 1,
                                      "moe_experts": E}), torch.Generator().manual_seed(1))
    params = {**dict(dense.named_parameters()),
              **{k: v for k, v in moe.named_parameters() if ".moe." in k}}
    for name, fan_in in (("blocks.0.attn.qkv.weight", D), ("blocks.0.attn.proj.weight", D),
                         ("blocks.0.ff.net.0.weight", D), ("blocks.0.ff.net.2.weight", Fh),
                         ("time_mlp.2.weight", D), ("patch_embed.proj.weight", 6 * 16),
                         ("blocks.0.moe.experts_in", E * D), ("blocks.0.moe.experts_out", E * Fh),
                         ("blocks.0.moe.router.weight", D)):
        got = float(params[name].detach().std())
        assert abs(got * fan_in ** 0.5 - 1) < 0.03, name


def test_train_and_generate_clis_at_dit_l_width_on_cpu(tmp_path, monkeypatch):
    """--embed-dim 1024 --depth 1 --heads 16 (DiT-L's width) on 4 synthetic
    images: the trainer's batch 2 x m 2 is T = 256 token rows, where the JAX
    ladder (and so the port's, from the real shapes) takes the F-chunked MLP
    at k = 2 and the split attention backward; then generate_torch samples
    2 images from the checkpoint through the same tiers."""
    seen = {"mlp": []}
    real_mlp = tiers.mlp_tier
    monkeypatch.setattr(tiers, "mlp_tier", lambda *a: seen["mlp"].append(real_mlp(*a))
                        or real_mlp(*a))
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=4))
    result = cli.main(["--synthetic", "--epochs", "1", "--batch", "2", "--m", "2",
                       "--embed-dim", "1024", "--depth", "1", "--heads", "16",
                       "--time-embed", "16", "--sample-batch", "2", "--sample-steps", "1",
                       "--log-every", "1", "--device", "cpu", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert not any(result["launches"]["train"].values())  # CPU: the plain versions
    assert ("fchunked", 2) in seen["mlp"] and set(seen["mlp"]) == {("fchunked", 2)}
    # the attention tier (K4 on the card; one plain backward serves both)
    assert tiers.attention_tier(2 * 2, 64, 1024, 16) == "split"
    assert tiers.attention_tier(2, 64, 1024, 16) == "split"
    seen["mlp"].clear()
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, 32, 32, 3) and np.isfinite(samples).all()
    assert set(seen["mlp"]) == {("fchunked", 2)}  # T = 2 x 64 rows in the sampler
