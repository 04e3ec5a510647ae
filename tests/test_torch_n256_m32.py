"""Parity of the port's 64-px path (N = 256 tokens through K2's cores past
N = 128) and m = 32 energy score (K9, the anchor-streaming kernel), and of
K3 at the 64-px recipe's D = 12,288, with the JAX package.

The JAX side runs its Pallas kernels in interpret mode (``_fused_stream``,
``_fused``, ``_fused_block``), with its plain versions made to raise where
the test proves the kernel path taken; the port runs the same numpy inputs
on CPU tensors, i.e. the plain versions that ``tests/test_torch_cuda.py``
holds its CUDA kernels to on the card. The energy dispatch, and the
``device: tpu`` of the shipped YAMLs, are checked as shape and config
functions.
"""

import argparse
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.energy as JE  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
import train_cifar10_dit_torch as cli  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, patchify_images  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import energy as TE  # noqa: E402
from ddm_tpu_torch.ops import kernel_config  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.config import apply_config, load_yaml_config  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

# the energy score: fp32 sums over D and the pairs taken in another order
ENERGY_RTOL, ENERGY_GRAD_RTOL = 1e-5, 1e-4
GCONF, GINTER = 0.7, -0.3
# the half-block: tests/test_torch_split_attention.py's rules, the absolute
# part scaled by each output's largest entry
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)
CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture()
def jax_energy_kernels_only(interpret_kernels, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("JAX took its plain energy terms, not a Pallas kernel")

    monkeypatch.setattr(JE, "_jnp_energy_terms", boom)


def _energy_inputs(B, m, D, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, m, D)).astype(np.float32),
            r.standard_normal((B, D)).astype(np.float32))


def _port_energy(xh, x0, beta):
    leaves = [torch.from_numpy(xh).requires_grad_(), torch.from_numpy(x0).requires_grad_()]
    conf, inter = TE.fused_energy_terms(*leaves, beta)
    torch.autograd.backward((conf, inter), (torch.tensor(GCONF), torch.tensor(GINTER)))
    return (float(conf.detach()), float(inter.detach()), leaves[0].grad.numpy(),
            leaves[1].grad.numpy())


def _jax_energy(xh, x0, beta, fn):
    (conf, inter), vjp = jax.vjp(lambda a, b: fn(a, b, beta), jnp.asarray(xh), jnp.asarray(x0))
    gxh, gx0 = vjp((jnp.float32(GCONF), jnp.float32(GINTER)))
    return float(conf), float(inter), np.asarray(gxh), np.asarray(gx0)


def _assert_energy_match(got, want):
    np.testing.assert_allclose(got[:2], want[:2], rtol=ENERGY_RTOL, atol=0)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ENERGY_GRAD_RTOL * np.abs(w).max())


def _reset_energy_counters():
    for c in (TE.FWD_LAUNCHES, TE.BWD_LAUNCHES, TE.STREAM_FWD_LAUNCHES, TE.STREAM_BWD_LAUNCHES):
        c.reset()


@pytest.mark.parametrize("shape", [(2, 24, 128), (2, 32, 256)])
@pytest.mark.parametrize("beta", [0.1, 1.0, 2.0])
def test_k9_matches_jax_stream_kernel(jax_energy_kernels_only, shape, beta):
    """K9's route: the JAX anchor-streaming kernel against the port's plain
    K9f/K9b, values and both gradients."""
    assert JE._stream_supported(*shape) and TE.energy_route(*shape) == "K9"
    xh, x0 = _energy_inputs(*shape, seed=1)
    _reset_energy_counters()
    got = _port_energy(xh, x0, beta)
    assert TE.STREAM_FWD_LAUNCHES.count == TE.STREAM_BWD_LAUNCHES.count == 0  # CPU: plain
    _assert_energy_match(got, _jax_energy(xh, x0, beta, JE.fused_energy_terms))


@pytest.mark.parametrize("beta", [0.1, 2.0])
def test_k3_at_d_12288_matches_jax_kernel(jax_energy_kernels_only, beta):
    """D = 12,288 (64 px at patch 4): the JAX gate admits K3, whose one image
    (240 KB of fp32 rows) exceeds a block's shared memory on the card; the
    port's K3 tiles D."""
    B, m, D = 8, 4, 12288
    assert JE._kernel_supported(B, m, D) and TE.energy_route(B, m, D) == "K3"
    xh, x0 = _energy_inputs(B, m, D, seed=2)
    _assert_energy_match(_port_energy(xh, x0, beta),
                         _jax_energy(xh, x0, beta, lambda a, b, be: JE._fused(a, b, be)))


def _jax_energy_choice(B, m, D, monkeypatch):
    """Which path ``fused_energy_terms`` takes, read through markers in
    place of its kernels and its jnp path (shape-only stand-ins)."""
    monkeypatch.setattr(JE, "_fused", lambda *a: "K3")
    monkeypatch.setattr(JE, "_fused_stream", lambda *a: "K9")
    monkeypatch.setattr(JE, "_jnp_energy_terms", lambda *a: None)
    stand_in = SimpleNamespace(shape=(B, m, D), astype=lambda dt: None)
    return JE.fused_energy_terms(stand_in, SimpleNamespace(astype=lambda dt: None), 0.1)


@pytest.mark.parametrize("m", [2, 8, 16, 17, 24, 32, 64, 72])
def test_energy_route_is_the_jax_dispatch(interpret_kernels, monkeypatch, m):
    """K3, K9 or the plain path, as ``fused_energy_terms`` picks them, over
    D = 3072, 12,288, 49,152 (32, 64, 128 px) and B = 64, 256; the gates
    equal JAX's too."""
    for D in (3072, 12288, 49152):
        for B in (64, 256):
            want = _jax_energy_choice(B, m, D, monkeypatch)
            assert TE.energy_route(B, m, D) == want, (B, m, D)
            assert TE.jax_kernel_gate(B, m, D) == JE._kernel_supported(B, m, D)
            assert TE.jax_stream_gate(B, m, D) == JE._stream_supported(B, m, D)
    assert TE.energy_route(256, 32, 3072) == "K9" and TE.energy_route(64, 4, 12288) == "K3"


def test_stream_plain_versions_are_the_energy_terms():
    """The anchor-walking K9 plain versions give the energy terms and their
    autograd, at m = 32."""
    xh, x0 = (torch.from_numpy(a) for a in _energy_inputs(3, 32, 64, seed=3))
    for beta in (0.1, 2.0):
        got = TE.energy_terms_stream_reference(xh, x0, beta)
        for g, w in zip(got, TE.energy_terms_reference(xh, x0, beta)):
            torch.testing.assert_close(g, w, rtol=ENERGY_RTOL, atol=0)
        leaves = [xh.clone().requires_grad_(), x0.clone().requires_grad_()]
        conf, inter = TE.energy_terms_reference(*leaves, beta)
        want = torch.autograd.grad((conf, inter), leaves,
                                   (torch.tensor(GCONF), torch.tensor(GINTER)))
        grads = TE.energy_terms_stream_bwd_reference(xh, x0, beta, torch.tensor(GCONF),
                                                     torch.tensor(GINTER))
        for g, w in zip(grads, want):
            assert float((g - w).abs().max()) <= ENERGY_GRAD_RTOL * float(w.abs().max())


def _attn_arrays(B, N, D, seed):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((B, N, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, 3 * D)), 0.1 * r.standard_normal(3 * D),
        D ** -0.5 * r.standard_normal((D, D)), 0.1 * r.standard_normal(D),
        r.standard_normal((B, N, D)))]


@pytest.mark.parametrize("N", [144, 256, 400])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_half_block_past_128_tokens_matches_jax(interpret_kernels, monkeypatch, N, dtype):
    """(2, N, 128), H 2: JAX's fused half-block kernels (g = 1) against the
    port's plain half-block, which the query-tile core and the two-pass
    backward follow on the card; the forward and all seven gradients."""
    def boom(*a, **k):
        raise AssertionError("JAX took its XLA half-block, not the Pallas kernels")

    monkeypatch.setattr(JA, "attention_block_reference", boom)
    B, D, H = 2, 128, 2
    assert JA._attn_pack(B, N, D, H) == 1 and JA._bwd_block_images(B, N, D, 1, H) >= 1
    *args, dout = _attn_arrays(B, N, D, seed=N)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda x, *w: JA.fused_attention_block(x, *w, H),
                       jnp.asarray(args[0], jdt), *(jnp.asarray(a) for a in args[1:]))
    want = [np.asarray(out.astype(jnp.float32))] + [
        np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dout, jdt))]

    t = [torch.from_numpy(a) for a in args]
    leaves = [t[0].to(tdt)] + [a.t().contiguous() if a.dim() == 2 else a for a in t[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    TA.LAUNCHES.reset()
    y = TA.fused_attention_block(*leaves, H)
    y.backward(torch.from_numpy(dout).to(tdt))
    assert TA.LAUNCHES.count == 0  # CPU tensors: the plain versions
    got = [y.detach().float().numpy()] + [
        (a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
        for i, a in enumerate(leaves)]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    names = ["out", "dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


# whole steps: a depth-2, D = 128 DiT at 64 px with m = 4 (N = 256, the
# energy score through K3 at D = 12,288) and at 32 px with m = 32 (K9)
STEPS = {"64px": dict(img=64, m=4), "m32": dict(img=32, m=32)}
DIM, DEPTH, HEADS, TDIM, PATCH, BETA, LAM = 128, 2, 2, 32, 4, 0.1, 1.0


def _jax_model(img, dtype):
    return JaxDiT(img_size=img, patch_size=PATCH, embed_dim=DIM, depth=DEPTH, num_heads=HEADS,
                  time_embed_dim=TDIM, dtype=dtype, data_format="NHWC")


@pytest.fixture(scope="module", params=sorted(STEPS))
def step_setup(request):
    """Weights with non-trivial LN params and biases, and one step's
    injected x0, t, eps and xi (batch 1)."""
    img, m = STEPS[request.param]["img"], STEPS[request.param]["m"]
    zeros = jnp.zeros((1, img, img, 3))
    variables = _jax_model(img, jnp.float32).init(jax.random.PRNGKey(0), zeros,
                                                  jnp.zeros((1,)), zeros)
    r = np.random.default_rng(7)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)
    shape = (1, img, img, 3)
    inputs = (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, 1).astype(np.float32),
              r.standard_normal(shape).astype(np.float32),
              r.standard_normal((1, m) + shape[1:]).astype(np.float32))
    return request.param, img, m, variables, inputs


def _jax_step(img, m, variables, inputs, dtype):
    """JAX's loss, token outputs and gradients of one step, its kernels in
    interpret mode and its plain energy terms made to raise."""
    model = _jax_model(img, dtype)
    x0, t, eps, xi = inputs

    def loss_fn(params):
        xt = jax_marginal(x0, t, eps)
        out = model.apply({"params": params}, jnp.repeat(xt, m, axis=0), jnp.repeat(t, m),
                          xi.reshape((m,) + x0.shape[1:]), method="tokens")
        target = jax_patchify(x0, PATCH).reshape(1, -1)
        conf, inter = JE.fused_energy_terms(out.reshape(1, m, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=0.0))
        return weight * (conf - (LAM / (2.0 * (m - 1))) * inter), out

    def boom(*a, **k):
        raise AssertionError("JAX took its plain energy terms or XLA half-block")

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        mp.setattr(JE, "_jnp_energy_terms", boom)
        mp.setattr(JA, "attention_block_reference", boom)
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(out, np.float32), {
        jax.tree_util.keystr(p): np.asarray(g, np.float32)
        for p, g in jax.tree_util.tree_leaves_with_path(grads)}


def _port_step(img, m, variables, inputs, dtype):
    model = DDDMDiT(img_size=img, patch_size=PATCH, embed_dim=DIM, depth=DEPTH,
                    num_heads=HEADS, time_embed_dim=TDIM, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=PATCH))
    outputs = []

    def tokens(*a):
        outputs.append(model.tokens(*a))
        return outputs[-1]

    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    loss, _ = distributional_training_step(
        tokens, x0, m=m, beta=BETA, lam=LAM, w_bias=0.0, t=t, eps=eps, xi=xi,
        target_transform=lambda a: patchify_images(a, PATCH))
    loss.backward()
    tree = jax_tree_from_state_dict({k: p.grad for k, p in model.named_parameters()},
                                    patch_size=PATCH)["params"]
    return float(loss.detach()), outputs[0].detach().float().numpy(), {
        jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_step_matches_jax_fp32(step_setup):
    """One step at 64 px (N = 256, K3 at D = 12,288) and at m = 32 (K9): the
    token outputs, the loss and every parameter gradient, fp32."""
    name, img, m, variables, inputs = step_setup
    assert TE.energy_route(1, m, 3 * img * img) == ("K3" if name == "64px" else "K9")
    want_loss, want_out, want = _jax_step(img, m, variables, inputs, jnp.float32)
    loss, out, got = _port_step(img, m, variables, inputs, torch.float32)
    assert out.shape == (m, (img // PATCH) ** 2, PATCH * PATCH * 3)
    np.testing.assert_allclose(out, want_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=path)


def test_step_bf16_lies_within_bf16_noise_of_jax(step_setup):
    """The bf16 step within 2 e of JAX's bf16 one, e = |JAX bf16 - JAX fp32|
    (relative Frobenius for the outputs and every gradient). At m = 32 the
    interaction term nearly cancels the confinement in some gradients (the
    patch embedding's bias: e = 0.17), so e is only bounded by 0.5."""
    name, img, m, variables, inputs = step_setup
    loss32, out32, want32 = _jax_step(img, m, variables, inputs, jnp.float32)
    loss16, out16, want16 = _jax_step(img, m, variables, inputs, jnp.bfloat16)
    loss, out, got = _port_step(img, m, variables, inputs, torch.bfloat16)
    assert abs(loss - loss16) <= 2 * abs(loss16 - loss32) + 1e-4 * abs(loss32)
    assert _rel_frob(out, out16) <= 2 * _rel_frob(out16, out32)
    for path, w in want16.items():
        noise = _rel_frob(w, want32[path])
        assert 0 < noise < 0.5, path
        assert _rel_frob(got[path], w) <= 2 * noise, path


@pytest.mark.parametrize("config", CONFIGS, ids=[c.name for c in CONFIGS])
def test_shipped_yaml_devices_map_to_the_card(config, monkeypatch):
    """Every shipped YAML sets ``device: tpu``; merged by ``apply_config``
    it reaches ``cli_device``, which names the card, not a bare
    ``torch.device('tpu')`` error."""
    yaml = load_yaml_config(str(config))
    assert yaml["device"] == "tpu"
    parser = argparse.ArgumentParser()
    parser.add_argument("--config")
    parser.add_argument("--device", default="cuda")
    for key in set(yaml) - {"device"}:
        parser.add_argument(f"--{key}", dest=key)
    args = parser.parse_args(["--config", str(config)])
    apply_config(parser, args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert kernel_config.cli_device(args.device) == torch.device("cuda")
    if config.name.startswith("cifar10"):  # the trainer's own parser
        trainer = cli.build_parser()
        args = trainer.parse_args(["--config", str(config)])
        apply_config(trainer, args)
        assert kernel_config.cli_device(args.device) == torch.device("cuda")
