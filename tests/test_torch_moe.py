"""Parity of the port's MoE path with the JAX package: the ``MoEMLP`` layer
(JAX's fused chain with its kernels in interpret mode, and its einsum
path), a ragged row count against JAX's padded einsum path, the Switch aux
loss and its gradient into the router, the flax init of the expert leaves,
the weight converter, a depth-2 MoE DiT forward and one MoE training step
against ``jax.grad`` of the JAX step.

Everything runs on CPU tensors, so the port takes the plain versions of
K10-K12; ``tests/test_torch_cuda.py`` holds the kernels to those on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.moe_dispatch as JD  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.models.factory import make_tokens_apply as jax_tokens_apply  # noqa: E402
from ddm_tpu.models.moe import MoEMLP as JaxMoE  # noqa: E402
from ddm_tpu.ops.energy import fused_energy_terms as jax_energy  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
from ddm_tpu_torch.models import factory as TF  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, init_params, patchify_images  # noqa: E402
from ddm_tpu_torch.models.moe import MoEMLP, make_moe_aux_apply, moe_mlp_reference  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

D, F, E, GS, AUX_W = 128, 256, 4, 32, 0.01
# name: (topk, capacity, experts); 128 experts at top-2 (Arctic's count)
LAYER_CASES = {"top1": (1, 1.25, E), "top2": (2, 1.25, E), "top1-drops": (1, 0.4, E),
               "e128-top2": (2, 1.25, 128)}
CFG = dict(img=16, patch=4, dim=128, depth=2, heads=2, tdim=32)
# DiT-XL/4's widths (D 1152, 16 heads of Dh 72, F 4608) at depth 1, 8 experts
XL_CFG, XL_E = dict(img=16, patch=4, dim=1152, depth=1, heads=16, tdim=32), 8
B, M, BETA, LAM, W_BIAS = 2, 4, 0.1, 1.0, 0.0
# fp32: sums over rows taken in another order (the kernel tests' 1e-4,
# the absolute part scaled by the leaf's largest entry)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
LEAVES = ("experts_in", "experts_in_bias", "experts_out", "experts_out_bias")


def _layer_setup(topk, capacity, T, seed=0, experts=E):
    r = np.random.default_rng(seed)
    rows = r.standard_normal((T, D)).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(D)).astype(np.float32)
    b = (0.1 * r.standard_normal(D)).astype(np.float32)
    mod = JaxMoE(D, F, experts, capacity_factor=capacity, group_size=GS, topk=topk,
                 dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(rows), ln_scale=jnp.asarray(s),
                      ln_bias=jnp.asarray(b))
    # non-zero biases, and a router whose logits spread over a few units
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape)
                          .astype(np.float32), params)
    params["params"]["router_kernel"] = params["params"]["router_kernel"] * 3.0
    cot = r.standard_normal((T, D)).astype(np.float32)
    return mod, params, rows, s, b, cot


def _jax_layer(mod, params, rows, s, b, cot, aux_only=False):
    def loss(p, rows_, s_, b_):
        out, mut = mod.apply(p, rows_, ln_scale=s_, ln_bias=b_, residual="rows",
                             mutable=["losses"])
        (aux,) = jax.tree.leaves(dict(mut)["losses"])
        main = 0.0 if aux_only else jnp.vdot(out.astype(jnp.float32), cot)
        return main + AUX_W * aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        params, *(jnp.asarray(a) for a in (rows, s, b)))
    p = grads[0]["params"]
    return np.asarray(out), float(aux), {
        "rows": grads[1], "s": grads[2], "b": grads[3],
        "router.weight": np.asarray(p["router_kernel"]).T, "router.bias": p["router_bias"],
        **{k: p[k] for k in LEAVES}}


def _port_layer(topk, capacity, params, rows, s, b, cot, aux_only=False, fn=None):
    """The port's layer (or ``fn(layer, rows, s, b)``) on the JAX params:
    output, aux and the gradients of ``<out, cot> + AUX_W * aux``."""
    p = params["params"]
    layer = MoEMLP(D, F, len(p["router_bias"]), capacity=capacity, group_size=GS, topk=topk)
    layer.load_state_dict({"router.weight": torch.from_numpy(np.asarray(p["router_kernel"]).T
                                                             .copy()),
                           "router.bias": torch.from_numpy(np.asarray(p["router_bias"])),
                           **{k: torch.from_numpy(np.asarray(p[k])) for k in LEAVES}})
    leaves = [torch.from_numpy(a).requires_grad_() for a in (rows, s, b)]
    out, aux = layer(*leaves) if fn is None else fn(layer, *leaves)
    main = 0.0 if aux_only else (out * torch.from_numpy(cot)).sum()
    (main + AUX_W * aux).backward()
    named = dict(layer.named_parameters())
    grads = {"rows": leaves[0].grad, "s": leaves[1].grad, "b": leaves[2].grad,
             **{k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in named.items()}}
    return out.detach().numpy(), float(aux.detach()), grads


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=k)


@pytest.mark.parametrize("kernels", ["interpret", "off"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(monkeypatch, case, kernels):
    """The port's MoEMLP ("rows" residual) against JAX's, its fused Pallas
    chain in interpret mode or its einsum path: output, aux and every
    gradient, router and experts included."""
    topk, capacity, experts = LAYER_CASES[case]
    mod, params, rows, s, b, cot = _layer_setup(topk, capacity, T=128, experts=experts)
    calls = []
    if kernels == "interpret":
        monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        real = JD.moe_dispatch_thru
        monkeypatch.setattr(JD, "moe_dispatch_thru", lambda *a: calls.append(1) or real(*a))
    want_out, want_aux, want = _jax_layer(mod, params, rows, s, b, cot)
    assert bool(calls) == (kernels == "interpret")  # the fused chain ran, or did not
    out, aux, got = _port_layer(topk, capacity, params, rows, s, b, cot)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("topk", [1, 2])
def test_ragged_rows_match_jax_padded_path(topk):
    """T = 100 is not a whole number of 32-row groups: the port pads to 128
    and runs the same ops with 100 valid rows; JAX takes its padded einsum
    path. Padded rows take no route and no capacity and add nothing to aux."""
    mod, params, rows, s, b, cot = _layer_setup(topk, 1.25, T=100, seed=3)
    want_out, want_aux, want = _jax_layer(mod, params, rows, s, b, cot)
    out, aux, got = _port_layer(topk, 1.25, params, rows, s, b, cot)
    assert out.shape == (100, D)
    np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("case", [*LAYER_CASES, "ragged"])
def test_einsum_reference_matches_jax_and_the_fused_chain(case):
    """The port's plain version of the whole layer, written after JAX's
    einsum path, against that path (kernels off), and the port's chain of
    K11/K10/K12 plain versions against it: output, aux and every gradient.
    "ragged" is T = 100 rows, padded to 128 in 32-row groups."""
    topk, capacity, experts = LAYER_CASES.get(case, (1, 1.25, E))
    setup = _layer_setup(topk, capacity, T=100 if case == "ragged" else 128, seed=7,
                         experts=experts)
    want_out, want_aux, want = _jax_layer(*setup)
    ref_out, ref_aux, ref = _port_layer(topk, capacity, *setup[1:], fn=moe_mlp_reference)
    np.testing.assert_allclose(ref_out, want_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref_aux, want_aux, rtol=1e-6)
    _assert_grads_close(ref, want)
    out, aux, got = _port_layer(topk, capacity, *setup[1:])
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux, ref_aux, rtol=1e-6)
    _assert_grads_close(got, {k: v.numpy() for k, v in ref.items()})


def test_aux_value_and_its_gradient_into_the_router():
    """The Switch aux alone: E * sum_e f_e P_e, and the gradient it sends
    into the router (through the prob sums) and LN2, nothing into the
    experts."""
    mod, params, rows, s, b, cot = _layer_setup(1, 1.25, T=128, seed=5)
    _, want_aux, want = _jax_layer(mod, params, rows, s, b, cot, aux_only=True)
    _, aux, got = _port_layer(1, 1.25, params, rows, s, b, cot, aux_only=True)
    assert aux >= 1.0 - 1e-6  # 1 when balanced, up to E when collapsed
    np.testing.assert_allclose(aux, want_aux, rtol=1e-6)
    assert float(np.abs(np.asarray(want["router.weight"])).max()) > 0
    for k in LEAVES:
        assert not got[k].any() and not np.asarray(want[k]).any(), k
    _assert_grads_close(got, want)


def test_expert_init_follows_flax_fan_in():
    """flax's lecun_normal takes fan_in = E * D for a (E, D, F) leaf: std
    1/sqrt(E D), not 1/sqrt(D). The port draws the same; within 3%."""
    Dw, Fw, Ew = 384, 1536, 8
    layer = init_params(MoEMLP(Dw, Fw, Ew), torch.Generator().manual_seed(0))
    mod = JaxMoE(Dw, Fw, Ew, group_size=64)
    p = mod.init(jax.random.PRNGKey(0), jnp.zeros((64, Dw)), ln_scale=jnp.ones(Dw),
                 ln_bias=jnp.zeros(Dw))["params"]
    for name, fan_in, jax_leaf in (("experts_in", Ew * Dw, p["experts_in"]),
                                   ("experts_out", Ew * Fw, p["experts_out"]),
                                   ("router.weight", Dw, p["router_kernel"])):
        want = fan_in ** -0.5
        got = float(dict(layer.named_parameters())[name].detach().std())
        assert abs(got / want - 1) < 0.03, name
        assert abs(float(np.asarray(jax_leaf).std()) / want - 1) < 0.03, name
    assert abs((Ew * Dw) ** -0.5 - 0.01804) < 1e-5
    for name in ("experts_in_bias", "experts_out_bias", "router.bias"):
        assert not dict(layer.named_parameters())[name].any(), name


def _jax_model(dtype, topk=1, cfg=CFG, experts=E):
    return JaxDiT(img_size=cfg["img"], patch_size=cfg["patch"], embed_dim=cfg["dim"],
                  depth=cfg["depth"], num_heads=cfg["heads"], time_embed_dim=cfg["tdim"],
                  dtype=dtype, data_format="NHWC", moe_experts=experts, moe_capacity=1.25,
                  moe_group_size=GS, moe_topk=topk)


def _jax_variables(seed=0, topk=1, router_gain=1.0, cfg=CFG, experts=E):
    x0 = jnp.zeros((1, cfg["img"], cfg["img"], 3))
    variables = _jax_model(jnp.float32, topk, cfg, experts).init(
        jax.random.PRNGKey(seed), x0, jnp.zeros((1,)), x0)
    r = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32),
        variables)
    for i in range(cfg["depth"]):
        moe = variables["params"][f"block_{i}"]["moe"]
        moe["router_kernel"] = moe["router_kernel"] * router_gain
    return variables


def _port_model(variables, dtype, topk=1, cfg=CFG, experts=E):
    model = DDDMDiT(img_size=cfg["img"], patch_size=cfg["patch"], embed_dim=cfg["dim"],
                    depth=cfg["depth"], num_heads=cfg["heads"], time_embed_dim=cfg["tdim"],
                    dtype=dtype, moe_experts=experts, moe_capacity=1.25, moe_group_size=GS,
                    moe_topk=topk)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=cfg["patch"]))
    return model


def test_convert_round_trips_a_moe_tree_leaf_for_leaf():
    variables = _jax_variables(seed=4)
    sd = state_dict_from_jax(variables, patch_size=CFG["patch"])
    assert sd["blocks.1.moe.router.weight"].shape == (E, CFG["dim"])
    assert sd["blocks.1.moe.experts_in"].shape == (E, CFG["dim"], 4 * CFG["dim"])
    assert not any(".ff." in k for k in sd)
    model = _port_model(variables, torch.float32)  # load_state_dict is strict
    back = jax_tree_from_state_dict(model.state_dict(), patch_size=CFG["patch"])
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(got)
    for path, v in leaves:
        np.testing.assert_array_equal(got[path], v, err_msg=jax.tree_util.keystr(path))


def _inputs(seed=1, n=8):
    r = np.random.default_rng(seed)
    shape = (n, CFG["img"], CFG["img"], 3)
    return (r.standard_normal(shape).astype(np.float32), r.uniform(0, 1, n).astype(np.float32),
            r.standard_normal(shape).astype(np.float32))


def test_moe_dit_forward_matches_jax():
    """Depth 2, 8 images x 16 tokens = 4 routing groups, JAX on its einsum
    path (kernels off). fp32 to 1e-4; bf16 within bf16's own noise as
    tests/test_torch_model.py holds it: e = |JAX bf16 - JAX fp32|, the port's
    bf16 forward within 2e of JAX's (max and mean) and of the fp32 one. The
    router is made decisive (gain 20), so that bf16 rounding moves no token
    to another expert and e measures arithmetic alone: a token routed
    elsewhere changes its output by far more than bf16 noise."""
    variables, (xt, t, xi) = _jax_variables(router_gain=20.0), _inputs()
    want32 = np.asarray(_jax_model(jnp.float32).apply(variables, xt, t, xi))
    want16 = np.asarray(_jax_model(jnp.bfloat16).apply(variables, xt, t, xi))
    args = (torch.from_numpy(xt), torch.from_numpy(t), torch.from_numpy(xi))
    with torch.inference_mode():
        got32 = _port_model(variables, torch.float32)(*args).numpy()
        got16 = _port_model(variables, torch.bfloat16)(*args).numpy()
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


@pytest.mark.parametrize("topk,xl", [(1, False), (2, False), (2, True)], ids=["1", "2", "2-xl"])
def test_moe_training_step_matches_jax_grad(topk, xl):
    """One fp32 step, B = 2 x m = 4 on 16-px images (128 rows, 4 groups),
    injected t, eps, xi: the denoiser's output, the loss terms, moe_aux and
    every gradient leaf against jax.grad of the JAX step (make_tokens_apply
    with the aux weight 0.01, its einsum path); also at DiT-XL/4's widths
    (depth 1, 8 experts, top-2)."""
    cfg, experts = (XL_CFG, XL_E) if xl else (CFG, E)
    variables, (x0, t, eps, xi) = (_jax_variables(seed=6, topk=topk, cfg=cfg, experts=experts),
                                   _step_inputs())
    model = _jax_model(jnp.float32, topk, cfg, experts)
    apply_fn = jax_tokens_apply(model, AUX_W)
    xt_m, t_m = jnp.repeat(jax_marginal(x0, t, eps), M, axis=0), jnp.repeat(t, M)
    xi_m = xi.reshape((B * M,) + x0.shape[1:])
    want_out = np.asarray(model.apply(variables, xt_m, t_m, xi_m))

    def loss_fn(params):
        xt = jax_marginal(x0, t, eps)
        out, aux = apply_fn({"params": params}, jnp.repeat(xt, M, axis=0), jnp.repeat(t, M),
                            xi.reshape((B * M,) + x0.shape[1:]))
        target = jax_patchify(x0, CFG["patch"]).reshape(B, -1)
        conf, inter = jax_energy(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=W_BIAS))
        loss = weight * (conf - (LAM / (2.0 * (M - 1))) * inter) + aux
        return loss, {"loss": loss, "confidence": conf, "interaction": inter, "moe_aux": aux}

    (_, want_m), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    want = {jax.tree_util.keystr(p): np.asarray(g, np.float32)
            for p, g in jax.tree_util.tree_leaves_with_path(grads)}

    port = _port_model(variables, torch.float32, topk, cfg, experts)
    assert TF.make_tokens_apply(port, 0.0) == port.tokens
    with torch.no_grad():
        got_out = port(*(torch.from_numpy(np.array(a)) for a in (xt_m, t_m, xi_m))).numpy()
    np.testing.assert_allclose(got_out, want_out, rtol=1e-4, atol=1e-4)
    _, metrics = distributional_training_step(
        TF.make_tokens_apply(port, AUX_W), *(torch.from_numpy(a) for a in (x0,)), m=M,
        beta=BETA, lam=LAM, w_bias=W_BIAS, t=torch.from_numpy(t), eps=torch.from_numpy(eps),
        xi=torch.from_numpy(xi), target_transform=lambda a: patchify_images(a, CFG["patch"]))
    metrics["loss"].backward()
    assert set(metrics) == {"loss", "confidence", "interaction", "weight", "moe_aux"}
    for k in ("loss", "confidence", "interaction", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(want_m[k]), rtol=1e-5, err_msg=k)
    named = dict(port.named_parameters())
    for name, p in named.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=cfg["patch"])["params"]
    got = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}
    assert set(got) == set(want) and len(got) == len(named)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=path)


def test_make_moe_aux_apply_refuses_a_dense_model():
    dense = TF.build_model({"image_size": 16, "embed_dim": 64, "depth": 1, "heads": 2,
                            "time_embed": 16, "dtype": "float32"})
    init_params(dense, torch.Generator().manual_seed(0))
    xt = torch.zeros((1, 16, 16, 3))
    with pytest.raises(ValueError, match="no MoE blocks"):
        make_moe_aux_apply(dense, 0.01)(xt, torch.zeros(1), xt)
    assert TF.make_tokens_apply(dense, 0.01) == dense.tokens
