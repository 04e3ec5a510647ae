"""DiT-XL/4's widths (D 1152, 16 heads of Dh 72, F 4608) and Dh 24 through
the port's plain versions, against the JAX package, whose Pallas kernels run
in interpret mode on the same numpy inputs:

- the attention half-block (K2f, and K4 or K2b by the ladder) at (4, 64,
  1152, H 16) (the split tier) and (8, 64, 384, H 16) (the fused tier at
  Dh 24), forward and its seven gradients;
- the standalone core K7 at (2, 256, 1152, H 16), forward and gradients;
- the F-chunked MLP half-block at D 1152 (two K6f partials, K1b's plain
  chain as its backward);
- a depth-1 XL DiT's forward and one training step, at 32 px (the
  half-block tiers) and at 64 px (the third rung around K7);
- ``state_dict_from_jax`` at XL width, and the trainer and sampler CLIs at
  XL width and depth 1 on the CPU.

The port runs on CPU tensors (its plain versions); the real shapes pick
each tier in both packages. The CUDA kernels, whose head tiles are padded
to 80 and 32 columns, are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` 3l and 6k).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
import generate_torch  # noqa: E402
import train_cifar10_dit_torch as cli  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.ops.energy import fused_energy_terms as jax_energy  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
from ddm_tpu_torch.data.cifar10 import CIFAR10DataConfig  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, patchify_images  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

XL_D, XL_H = 1152, 16
NAMES = ["x", "scale", "bias", "wqkv", "bqkv", "wproj", "bproj"]
MLP_NAMES = ["x", "scale", "bias", "w1", "b1", "w2", "b2"]
B, M, BETA, LAM, W_BIAS, TDIM = 2, 2, 0.1, 1.0, 0.0, 32


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


def _close(got, want, dtype, name):
    """fp32: 1e-4 relative (fp32 sums of up to 4608 terms taken in another
    order), the absolute part at 1e-5 of the largest entry. bf16: the rule
    of tests/test_torch_split_attention.py, 1e-2 relative and 3.2e-2 of the
    largest entry (a flipped rounding of one bf16 intermediate, qkv, P, dS,
    g or datt, moves single entries by a bf16 unit)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rtol, atol = (1e-4, 1e-5) if dtype == "float32" else (1e-2, 3.2e-2)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _attn_inputs(Bn, N, D, seed):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((Bn, N, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, 3 * D)), 0.1 * r.standard_normal(3 * D),
        D ** -0.5 * r.standard_normal((D, D)), 0.1 * r.standard_normal(D),
        r.standard_normal((Bn, N, D)))]


def _port_grads(fn, arrays, dtype):
    """``fn`` over the port's leaves (x in ``dtype``, 2-D weights in
    nn.Linear's layout) through autograd: (out, gradients in JAX's layout)."""
    *args, dout = [torch.from_numpy(a) for a in arrays]
    leaves = [args[0].to(dtype)] + [a.t().contiguous() if a.dim() == 2 else a for a in args[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    out = fn(*leaves)
    out.backward(dout.to(out.dtype))
    grads = [(a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
             for i, a in enumerate(leaves)]
    return out.detach().float().numpy(), grads


def _jax_grads(fn, arrays, dtype):
    *args, dout = arrays
    dt = getattr(jnp, dtype)
    y, vjp = jax.vjp(fn, jnp.asarray(args[0], dt), *(jnp.asarray(a) for a in args[1:]))
    grads = vjp(jnp.asarray(dout, dt))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bn,D,H,tier", [(4, XL_D, XL_H, "split"), (8, 384, 16, "fused")],
                         ids=["xl-dh72-split", "dits-dh24-fused"])
def test_half_block_matches_jax(interpret, Bn, D, H, tier, dtype):
    """JAX's ``fused_attention_block`` takes the tier its ladder picks (the
    split backward at D 1152, the fused one at Dh 24), and so does the port:
    its plain K2f and K4/K2b chain, forward and seven gradients."""
    N = 64
    assert tiers.attention_tier(Bn, N, D, H) == tier
    arrays = _attn_inputs(Bn, N, D, seed=3)
    want_out, want = _jax_grads(lambda *a: JA.fused_attention_block(*a, H), arrays, dtype)
    got_out, got = _port_grads(lambda *a: TA.fused_attention_block(*a, H), arrays,
                               getattr(torch, dtype))
    _close(got_out, want_out, dtype, "out")
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, dtype, f"gradient of {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_core_matches_jax_at_dh72(interpret, dtype):
    """The plain K7 core (``attention_reference`` and
    ``attention_core_bwd_reference``, K7f's and K7b's plain versions) at
    (2, 256, 1152, H 16) against JAX's ``fused_attention`` (its K7 kernels,
    ``_fwd_kernel`` and ``_bwd_kernel``)."""
    Bn, N = 2, 256
    assert tiers.core_tier(Bn, N, XL_D, XL_H) == "K7"
    r = np.random.default_rng(4)
    q, k, v, do = (r.standard_normal((Bn, N, XL_D)).astype(np.float32) for _ in range(4))
    dt = getattr(jnp, dtype)
    y, vjp = jax.vjp(lambda *a: JA.fused_attention(*a, XL_H),
                     *(jnp.asarray(a, dt) for a in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, dt))]
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = TA.fused_attention(*leaves, XL_H)
    out.backward(torch.from_numpy(do).to(tdt))
    _close(out.detach().float().numpy(), np.asarray(y.astype(jnp.float32)), dtype, "o")
    for name, t, w in zip("qkv", leaves, want):
        _close(t.grad.float().numpy(), w, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fchunked_mlp_matches_jax_at_d1152(interpret, dtype):
    """The MLP half-block at (256, 1152, F 4608), where both ladders take the
    F-chunked forward at k = 2 (JAX's ``_fused_fwdonly_fchunked``, two
    ``_partial_fwd_kernel`` chunks, and XLA's backward; the port's two plain
    K6f partials and K1b's plain chain)."""
    T, D = 256, XL_D
    F = 4 * D
    assert tiers.mlp_tier(T, D, F) == ("fchunked", 2)
    r = np.random.default_rng(5)
    arrays = [a.astype(np.float32) for a in (
        r.standard_normal((T, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, F)), 0.1 * r.standard_normal(F),
        F ** -0.5 * r.standard_normal((F, D)), 0.1 * r.standard_normal(D),
        r.standard_normal((T, D)))]
    calls = []
    real = JM._fused_partial_fwd_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "_fused_partial_fwd_call", lambda *a: calls.append(1) or real(*a))
        want_out, want = _jax_grads(JM.fused_mlp_block, arrays, dtype)
    assert len(calls) == 2  # JAX ran its chunked kernel twice
    got_out, got = _port_grads(TM.fused_mlp_block, arrays, getattr(torch, dtype))
    _close(got_out, want_out, dtype, "out")
    for name, g, w in zip(MLP_NAMES, got, want):
        _close(g, w, dtype, f"gradient of {name}")


def _jax_model(img, dtype=jnp.float32):
    return JaxDiT(img_size=img, patch_size=4, embed_dim=XL_D, depth=1, num_heads=XL_H,
                  time_embed_dim=TDIM, dtype=dtype, data_format="NHWC")


def _variables(img, seed=0):
    x0 = jnp.zeros((1, img, img, 3))
    variables = _jax_model(img).init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)), x0)
    r = np.random.default_rng(seed)  # non-trivial LN params and biases
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)


def _port_model(variables, img):
    model = DDDMDiT(img_size=img, patch_size=4, embed_dim=XL_D, depth=1, num_heads=XL_H,
                    time_embed_dim=TDIM, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=4))
    return model


def test_state_dict_from_jax_carries_xl_weights():
    """Every leaf of a JAX XL block reaches the port's model unchanged (the
    dense kernels transposed to nn.Linear's layout), and back."""
    variables = _variables(32)
    model = _port_model(variables, 32)
    params, block = variables["params"], variables["params"]["block_0"]
    named = dict(model.named_parameters())
    assert named["blocks.0.attn.qkv.weight"].shape == (3 * XL_D, XL_D)
    for key, leaf in (("blocks.0.attn.qkv.weight", block["attn"]["qkv"]["kernel"].T),
                      ("blocks.0.attn.proj.weight", block["attn"]["proj"]["kernel"].T),
                      ("blocks.0.ff.net.0.weight", block["ff_in"]["kernel"].T),
                      ("blocks.0.ff.net.2.weight", block["ff_out"]["kernel"].T),
                      ("blocks.0.ff.net.0.bias", block["ff_in"]["bias"])):
        assert np.array_equal(named[key].detach().numpy(), leaf), key
    back = jax_tree_from_state_dict(model.state_dict(), patch_size=4)["params"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree_util.tree_leaves_with_path(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), jax.tree_util.keystr(path)


def _step_inputs(img, seed=2):
    r = np.random.default_rng(seed)
    shape = (B, img, img, 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_step(variables, inputs, img):
    model = _jax_model(img)
    x0, t, eps, xi = inputs

    def loss_fn(params):
        xt = jnp.repeat(jax_marginal(x0, t, eps), M, axis=0)
        out = model.apply({"params": params}, xt, jnp.repeat(t, M),
                          xi.reshape((B * M,) + x0.shape[1:]), method="tokens")
        target = jax_patchify(x0, 4).reshape(B, -1)
        conf, inter = jax_energy(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=W_BIAS))
        loss = weight * (conf - (LAM / (2.0 * (M - 1))) * inter)
        return loss, {"loss": loss, "confidence": conf, "interaction": inter}

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return ({k: float(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(p): np.asarray(g, np.float32)
             for p, g in jax.tree_util.tree_leaves_with_path(grads)})


def _port_step(variables, inputs, img):
    model = _port_model(variables, img)
    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    _, metrics = distributional_training_step(
        model.tokens, x0, m=M, beta=BETA, lam=LAM, w_bias=W_BIAS, t=t, eps=eps, xi=xi,
        target_transform=lambda a: patchify_images(a, 4))
    metrics["loss"].backward()
    named = dict(model.named_parameters())
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=4)["params"]
    grads = {jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}
    assert len(grads) == len(named)
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("img,attn,core", [(32, "split", "K7"), (64, None, "K7")],
                         ids=["32px", "64px"])
def test_depth1_xl_dit_matches_jax(interpret, img, attn, core):
    """A depth-1 DiT-XL/4, fp32: the forward on 4 images to 1e-4, then one
    training step (B = 2 x m = 2, injected t, eps, xi): the loss terms to
    1e-4 relative and every gradient leaf to 1e-4 with the absolute part at
    1e-5 of its largest entry. At 32 px both packages take the split
    half-block tier; at 64 px (N = 256) the third rung around K7."""
    N = (img // 4) ** 2
    assert tiers.attention_tier(B * M, N, XL_D, XL_H) == attn
    assert tiers.core_tier(B * M, N, XL_D, XL_H) == core
    variables = _variables(img)
    r = np.random.default_rng(1)
    xt, xi = (r.standard_normal((4, img, img, 3)).astype(np.float32) for _ in range(2))
    t = r.uniform(0, 1, 4).astype(np.float32)
    want = np.asarray(_jax_model(img).apply(variables, xt, t, xi))
    with torch.inference_mode():
        got = _port_model(variables, img)(*(torch.from_numpy(a) for a in (xt, t, xi))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    inputs = _step_inputs(img)
    want_m, want_g = _jax_step(variables, inputs, img)
    got_m, got_g = _port_step(variables, inputs, img)
    assert set(got_g) == set(want_g)
    for k in ("loss", "confidence", "interaction"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, err_msg=k)
    for path, w in want_g.items():
        np.testing.assert_allclose(got_g[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=path)


@pytest.mark.parametrize("img", [32, 64])
def test_train_and_generate_clis_at_xl_width_on_cpu(tmp_path, monkeypatch, img):
    """``--embed-dim 1152 --depth 1 --heads 16`` (DiT-XL's width) on 4
    synthetic images: the trainer's batch 2 x m 2 runs the F-chunked MLP at
    k = 2 and, at 32 px, the split attention tier, at 64 px the third rung
    around K7 (plain versions on the CPU); generate_torch samples 2 images
    from the checkpoint through the same path."""
    seen = {"mlp": [], "core": []}
    real_mlp, real_core = tiers.mlp_tier, tiers.core_tier
    monkeypatch.setattr(tiers, "mlp_tier", lambda *a: seen["mlp"].append(real_mlp(*a))
                        or real_mlp(*a))
    monkeypatch.setattr(tiers, "core_tier", lambda *a: seen["core"].append(real_core(*a))
                        or real_core(*a))
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=4))
    result = cli.main(["--synthetic", "--epochs", "1", "--batch", "2", "--m", "2",
                       "--embed-dim", "1152", "--depth", "1", "--heads", "16",
                       "--image-size", str(img), "--time-embed", "16", "--sample-batch", "2",
                       "--sample-steps", "1", "--log-every", "1", "--device", "cpu",
                       "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert not any(result["launches"]["train"].values())  # CPU: the plain versions
    assert set(seen["mlp"]) == {("fchunked", 2)}
    assert set(seen["core"]) == (set() if img == 32 else {"K7"})
    assert tiers.attention_tier(4, (img // 4) ** 2, 1152, 16) == ("split" if img == 32 else None)
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, img, img, 3) and np.isfinite(samples).all()
