"""The fast GELU, ``x sigmoid(1.702 x)`` (``--fast-gelu``; the JAX package's
``DDM_TPU_FAST_GELU=1``), against the JAX package, whose Pallas kernels run
in interpret mode on the same numpy inputs:

- the plain versions of K1 (forward and its seven gradients), K6f and K6b
  (the MLP partial and its backward), K10 (the expert FFN, forward and
  backward) and K10p (its F-chunked partials) with ``fast_gelu=True``;
- one DiT-S training step and one MoE training step of a depth-2 model;
- both CLIs accept ``--fast-gelu`` and carry it to the model;
- with the flag off every plain version is bit for bit the erf path.

JAX reads the switch when it traces (``ddm_tpu/ops/pallas_config.py:32-44``),
so the fixture sets it and clears JAX's caches before and after each test:
every JAX function here is traced afresh under the switch, and no trace made
under it outlives the test. The CUDA epilogues are held to these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` 3m).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.expert_ffn as JX  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
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
from ddm_tpu_torch.models.dit import DDDMDiT, patchify_images  # noqa: E402
from ddm_tpu_torch.ops import expert_ffn as TX  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

T, D, F = 128, 128, 512
E, S = 4, 128
NAMES = ["x", "scale", "bias", "w1", "b1", "w2", "b2"]
CFG = dict(img=16, patch=4, dim=128, depth=2, heads=2, tdim=32)
MOE = dict(moe_experts=4, moe_capacity=1.25, moe_group_size=32, moe_topk=1)
B, M, BETA, LAM, W_BIAS, AUX_W = 2, 4, 0.1, 1.0, 0.0, 0.01
ROUTER_GAIN = 20.0  # a decisive router: fp32 sums in another order move no token


@pytest.fixture()
def fast(monkeypatch):
    """The JAX kernels in interpret mode under ``DDM_TPU_FAST_GELU=1``,
    traced afresh in this test and in no other."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DDM_TPU_FAST_GELU", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _close(got, want, dtype, name, grad=False):
    """fp32: 1e-4 relative (fp32 sums taken in another order), the absolute
    part at 1e-5 of the largest entry. bf16 outputs: one bf16 unit at the
    largest entry, mean below 1e-3 (a flipped rounding of single bf16 g or
    output entries); bf16-run gradients as tests/test_torch_backward.py
    holds K1b: 1e-2 relative, 3.2e-2 of the largest entry (JAX rounds some
    weight cotangents to bf16 where the port keeps fp32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = max(1.0, float(np.abs(want).max()))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * top, err_msg=name)
    elif grad:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=3.2e-2 * top, err_msg=name)
    else:
        ulp = 2.0 ** (np.floor(np.log2(max(float(np.abs(want).max()), 1e-30))) - 7)
        assert np.abs(got - want).max() <= ulp, name
        assert np.abs(got - want).mean() <= 1e-3, name


def _mlp_inputs(seed=0, scale_h=2.0):
    """h = LN(x) W1 + b1 spread over |h| <= ~6, where the two GELUs differ
    most (up to 0.02 near |h| = 2)."""
    r = np.random.default_rng(seed)
    a = dict(x=r.standard_normal((T, D)), scale=1 + 0.1 * r.standard_normal(D),
             bias=0.1 * r.standard_normal(D),
             w1=scale_h * D ** -0.5 * r.standard_normal((D, F)), b1=0.1 * r.standard_normal(F),
             w2=F ** -0.5 * r.standard_normal((F, D)), b2=0.1 * r.standard_normal(D),
             dout=r.standard_normal((T, D)))
    return {k: np.asarray(v, np.float32) for k, v in a.items()}


def _port_leaves(a, dtype, names=NAMES):
    """The port's arguments: x in ``dtype``, weights in nn.Linear's layout."""
    out = [torch.from_numpy(a["x"]).to(dtype)]
    out += [torch.from_numpy(a[k].T.copy() if a[k].ndim == 2 else a[k]) for k in names[1:]]
    return [t.requires_grad_() for t in out]


def _from_port(leaves):
    return [(t.grad.t() if t.grad.dim() == 2 and i else t.grad).float().numpy()
            for i, t in enumerate(leaves)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_matches_jax_k1(fast, dtype):
    """K1's plain versions with ``fast_gelu`` against JAX's fused kernel pair
    (``_fused``: ``_fwd_kernel`` and ``_bwd_kernel`` under the switch)."""
    a = _mlp_inputs()
    dt = getattr(jnp, dtype)
    args = [jnp.asarray(a["x"], dt)] + [jnp.asarray(a[k]) for k in NAMES[1:]]
    y, vjp = jax.vjp(JM._fused, *args)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(a["dout"], dt))]
    leaves = _port_leaves(a, getattr(torch, dtype))
    out = TM.fused_mlp_block(*leaves, fast_gelu=True)
    out.backward(torch.from_numpy(a["dout"]).to(out.dtype))
    _close(out.detach().float().numpy(), np.asarray(y.astype(jnp.float32)), dtype, "out")
    for name, g, w in zip(NAMES, _from_port(leaves), want):
        _close(g, w, dtype, f"gradient of {name}", grad=True)


def test_mlp_partial_matches_jax_k6(fast):
    """K6f's and K6b's plain versions with ``fast_gelu`` against JAX's
    ``_fused_partial`` (``_partial_fwd_kernel`` and ``_partial_bwd_kernel``),
    fp32 partial and fp32 cotangent, bf16 activations."""
    a = _mlp_inputs(seed=1)
    do = a["dout"]
    args = [jnp.asarray(a["x"], jnp.bfloat16)] + [jnp.asarray(a[k]) for k in NAMES[1:6]]
    y, vjp = jax.vjp(JM._fused_partial, *args)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do))]
    leaves = _port_leaves(a, torch.bfloat16, NAMES[:6])
    out = TM.fused_mlp_partial(*leaves, fast_gelu=True)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(do))
    _close(out.detach().numpy(), np.asarray(y), "bfloat16", "partial")  # bf16 g, fp32 sum
    for name, g, w in zip(NAMES, _from_port(leaves), want):
        _close(g, w, "bfloat16", f"gradient of {name}", grad=True)


def _ffn_inputs(seed=2):
    r = np.random.default_rng(seed)
    a = dict(x=r.standard_normal((E, S, D)), w1=2 * D ** -0.5 * r.standard_normal((E, D, F)),
             b1=0.1 * r.standard_normal((E, F)), w2=F ** -0.5 * r.standard_normal((E, F, D)),
             b2=0.1 * r.standard_normal((E, D)), dout=r.standard_normal((E, S, D)))
    return {k: np.asarray(v, np.float32) for k, v in a.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_jax_k10(fast, dtype):
    """K10's plain versions with ``fast_gelu`` against JAX's ``expert_ffn``
    (``_fwd_kernel``, ``_bwd_kernel``), forward and five gradients."""
    a = _ffn_inputs()
    dt = getattr(jnp, dtype)
    keys = ("x", "w1", "b1", "w2", "b2")
    args = [jnp.asarray(a["x"], dt)] + [jnp.asarray(a[k]) for k in keys[1:]]
    y, vjp = jax.vjp(JX.expert_ffn, *args)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(a["dout"], dt))]
    leaves = [torch.from_numpy(a["x"]).to(getattr(torch, dtype))] + [
        torch.from_numpy(a[k]) for k in keys[1:]]
    leaves = [t.requires_grad_() for t in leaves]
    out = TX.expert_ffn(*leaves, fast_gelu=True)
    out.backward(torch.from_numpy(a["dout"]).to(out.dtype))
    _close(out.detach().float().numpy(), np.asarray(y.astype(jnp.float32)), dtype, "out")
    for name, t, w in zip(keys, leaves, want):
        _close(t.grad.float().numpy(), w, dtype, f"gradient of {name}", grad=True)


@pytest.mark.parametrize("k", [2, 4])
def test_expert_partials_match_jax_k10p(fast, k):
    """K10p's chunked plain forward with ``fast_gelu`` against JAX's
    ``_fwd_call_chunked`` at k chunks, bf16 slot rows."""
    a = _ffn_inputs(seed=3)
    keys = ("x", "w1", "b1", "w2", "b2")
    want = JX._fwd_call_chunked(jnp.asarray(a["x"], jnp.bfloat16),
                                *(jnp.asarray(a[n]) for n in keys[1:]), k)
    got = TX.expert_ffn_fchunked_reference(torch.from_numpy(a["x"]).bfloat16(),
                                           *(torch.from_numpy(a[n]) for n in keys[1:]), k,
                                           fast_gelu=True)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), "bfloat16", "out")


def _jax_model(dtype, moe):
    return JaxDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                  depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                  dtype=dtype, data_format="NHWC", **(MOE if moe else {}))


def _variables(moe, seed=6):
    x0 = jnp.zeros((1, CFG["img"], CFG["img"], 3))
    variables = _jax_model(jnp.float32, moe).init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)),
                                                  x0)
    r = np.random.default_rng(seed)  # non-trivial LN params and biases
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)
    for i in range(CFG["depth"]):
        block = variables["params"][f"block_{i}"]
        if moe:
            block["moe"]["router_kernel"] = block["moe"]["router_kernel"] * ROUTER_GAIN
            block["moe"]["experts_in"] = block["moe"]["experts_in"] * 2.0
        else:  # h over |h| <= ~6, where the two GELUs differ most
            block["ff_in"]["kernel"] = block["ff_in"]["kernel"] * 2.0
    return variables


def _step_inputs(seed=2):
    r = np.random.default_rng(seed)
    shape = (B, CFG["img"], CFG["img"], 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_step(variables, inputs, moe):
    model = _jax_model(jnp.float32, moe)
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


def _port_step(variables, inputs, moe, fast_gelu):
    model = DDDMDiT(img_size=CFG["img"], patch_size=CFG["patch"], embed_dim=CFG["dim"],
                    depth=CFG["depth"], num_heads=CFG["heads"], time_embed_dim=CFG["tdim"],
                    dtype=torch.float32, fast_gelu=fast_gelu, **(MOE if moe else {}))
    model.load_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]))
    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    _, metrics = distributional_training_step(
        TF.make_tokens_apply(model, AUX_W), x0, m=M, beta=BETA, lam=LAM, w_bias=W_BIAS,
        t=t, eps=eps, xi=xi, target_transform=lambda a: patchify_images(a, CFG["patch"]))
    metrics["loss"].backward()
    named = dict(model.named_parameters())
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=CFG["patch"])["params"]
    grads = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_training_step_matches_jax(fast, moe):
    """One fp32 step of a depth-2 DiT-S-shaped model (B = 2 x m = 4 on 16-px
    images, injected t, eps, xi) with the fast GELU in both packages: the
    loss terms (and moe_aux) to 1e-4 relative, every gradient leaf to 1e-4
    with the absolute part at 1e-5 of its largest entry. The erf step's
    gradients lie far outside that (relative Frobenius over 1e-3): the
    comparison sees the switch."""
    variables, inputs = _variables(moe), _step_inputs()
    want_m, want = _jax_step(variables, inputs, moe)
    got_m, got = _port_step(variables, inputs, moe, fast_gelu=True)
    assert set(got) == set(want)
    for k in ("loss", "confidence", "interaction") + (("moe_aux",) if moe else ()):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, err_msg=k)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=path)
    _, erf = _port_step(variables, inputs, moe, fast_gelu=False)
    moved = max(_rel_frob(erf[p], w) for p, w in want.items() if "ff_in" in p or "experts" in p)
    assert moved > 1e-3


def _tiny_run(tmp_path, monkeypatch, *flags):
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=2))
    return cli.main(["--synthetic", "--epochs", "1", "--batch", "2", "--m", "2", "--embed-dim",
                     "64", "--depth", "1", "--heads", "2", "--time-embed", "16",
                     "--sample-batch", "1", "--sample-steps", "1", "--device", "cpu", "--out",
                     str(tmp_path), *flags])


def test_clis_accept_fast_gelu(tmp_path, monkeypatch):
    """``train_cifar10_dit_torch.py --fast-gelu`` trains with the sigmoid
    GELU in every block (plain MoE blocks included) and records it in the
    checkpoint's config; ``generate_torch.py`` takes it only when asked, as
    ``generate.py`` sets ``DDM_TPU_FAST_GELU`` only for its flag."""
    built = []
    real = TF.build_model

    def spy(cfg, *a, **k):
        built.append(real(cfg, *a, **k))
        return built[-1]

    monkeypatch.setattr(cli, "build_model", spy)
    _tiny_run(tmp_path, monkeypatch, "--fast-gelu", "--moe-experts", "2", "--moe-group-size",
              "32")
    assert built and all(b.fast_gelu and all(blk.moe.fast_gelu for blk in b.blocks)
                         for b in built)
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert np.isfinite(history["loss"]).all()
    assert json.loads((tmp_path / "config.json").read_text())["fast_gelu"] is True
    monkeypatch.setattr(generate_torch, "build_model", spy)
    for flags, want in (([], False), (["--fast-gelu"], True)):
        built.clear()
        out = generate_torch.main(["--ckpt", str(tmp_path), "--n", "1", "--steps", "1",
                                   "--device", "cpu", "--out", "", *flags])
        assert np.isfinite(out["samples"]).all()
        assert [b.fast_gelu for b in built] == [want]
        assert all(blk.moe.fast_gelu is want for blk in built[0].blocks)


def test_flag_off_is_the_erf_path():
    """With ``fast_gelu`` False (the default) every plain version computes
    bit for bit the exact-erf GELU it computed before the switch existed,
    and a model built without the key is the model built with it False;
    with it on, the values move."""
    r = np.random.default_rng(4)
    h = torch.from_numpy(6 * r.standard_normal((64, 256)).astype(np.float32))
    assert torch.equal(TM.gelu(h), torch.nn.functional.gelu(h, approximate="none"))
    erf = torch.erf(h * (1.0 / np.sqrt(2.0)))
    g, dg = TM._gelu_and_grad(h)
    assert torch.equal(g, 0.5 * h * (1.0 + erf))
    assert torch.equal(dg, 0.5 * (1.0 + erf) + h * (1.0 / np.sqrt(2.0 * np.pi))
                       * torch.exp(-0.5 * h * h))
    a = _mlp_inputs(seed=5)
    args = [t.detach() for t in _port_leaves(a, torch.bfloat16)]
    dout = torch.from_numpy(a["dout"]).bfloat16()
    for fn, extra in ((TM.mlp_block_reference, ()), (TM.mlp_block_bwd_reference, (dout,)),
                      (TM.mlp_partial_reference, None), (TM.mlp_block_fchunked_reference, (2,))):
        call = args[:6] if extra is None else args + list(extra)
        base, off, on = fn(*call), fn(*call, fast_gelu=False), fn(*call, fast_gelu=True)
        for b, o, n in zip(*(t if isinstance(t, tuple) else (t,) for t in (base, off, on))):
            assert torch.equal(b, o)
        assert not all(torch.equal(b, n) for b, n in zip(
            *(t if isinstance(t, tuple) else (t,) for t in (base, on))))
    xt = torch.from_numpy(r.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t = torch.full((2,), 0.5)
    models = [TF.build_model({"image_size": 16, "embed_dim": 64, "depth": 1, "heads": 2,
                              "time_embed": 16, **extra}) for extra in
              ({}, {"fast_gelu": False}, {"fast_gelu": True})]
    state = models[0].state_dict()
    with torch.no_grad():
        for p in state.values():
            p.copy_(torch.from_numpy(0.3 * r.standard_normal(tuple(p.shape)).astype(np.float32)))
        outs = []
        for model in models:
            model.load_state_dict(state)
            outs.append(model(xt, t, xt))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
