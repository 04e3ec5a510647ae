"""The MLP half-block past D 1344 and a DiT at Stable Diffusion 3 Medium's
transformer widths (D 1536, 24 heads of Dh 64, MLP ratio 4: F 6144) through
the port's plain versions, against the JAX package, whose Pallas kernels run
in interpret mode on the same numpy inputs:

- ``tiers.mlp_tier`` against the JAX ladder at D 1408-4096 (D % 128 == 0),
  MLP ratios 1, 2 and 4: the ``fwdonly`` and ``fchunked`` tiers past the
  port's resident-panel GEMM width;
- the ``fchunked`` half-block at (128, 1536, F 6144), k = 4 K6f chunks in
  both packages, and the ``fwdonly`` half-block at (128, 1408, F 1408) (K1f),
  forward and seven gradients (K1b's plain chain, JAX's XLA backward);
- ``state_dict_from_jax`` at D 1536, a depth-1 DiT at that width (forward
  and one training step), and the trainer and sampler CLIs on the CPU;
- on meta tensors with ``uses_kernel`` answering True (the card's path,
  shapes only, through a recording stand-in for the kernel library): every
  MLP tier past D 1344 reaches every launch of its forward and of K1b's
  chain, and the attention half at D 1536 still takes the third rung's
  plain products around K7.

The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` 3p, 6p and 7o).
"""

import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
from ddm_tpu_torch.models.factory import build_model  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

# SD3-Medium's transformer (Esser et al. 2024): depth 24, 24 heads of 64
SD3_D, SD3_H, SD3_DEPTH = 1536, 24, 24
MLP_NAMES = ["x", "scale", "bias", "w1", "b1", "w2", "b2"]
B, M, BETA, LAM, W_BIAS, TDIM = 2, 2, 0.1, 1.0, 0.0, 32


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


def _close(got, want, dtype, name):
    """fp32: 1e-4 relative (fp32 sums of up to 6144 terms taken in another
    order), the absolute part at 1e-5 of the largest entry. bf16: 1e-2
    relative and 3.2e-2 of the largest entry (a flipped rounding of one bf16
    intermediate, y or g, moves single entries by a bf16 unit). The rules of
    tests/test_torch_dit_xl.py."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rtol, atol = (1e-4, 1e-5) if dtype == "float32" else (1e-2, 3.2e-2)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())), err_msg=name)


# --- the tier ladder past D 1344 ---

@pytest.fixture()
def jax_mlp_gate(monkeypatch):
    """JAX's ``fused_mlp_block`` with markers in place of its tiers."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    for hatch in ("DDM_TPU_MLP_VMEM_MB", "DDM_TPU_MLP_ROW_BLOCK"):
        monkeypatch.delenv(hatch, raising=False)
    monkeypatch.setattr(JM, "_fused", lambda *a: ("fused", 1))
    monkeypatch.setattr(JM, "_fused_fwdonly", lambda *a: ("fwdonly", 1))
    monkeypatch.setattr(JM, "_fused_fwdonly_fchunked", lambda x, s, b, w1, *a: (
        "fchunked", JM._mlp_fwd_fchunks(x.shape[0], x.shape[1], w1.shape[1])))
    monkeypatch.setattr(JM, "mlp_block_reference", lambda *a, **k: None)


def _shaped(*shape):
    return SimpleNamespace(shape=shape, dtype=None)


@pytest.mark.parametrize("D", range(1408, 4097, 128))
def test_mlp_tier_matches_jax_past_1344(jax_mlp_gate, D):
    """At every D % 128 == 0 from 1408 to 4096, MLP ratios 1, 2 and 4 and
    the trainer's and sampler's row counts, the port's ladder takes JAX's
    tier: ``fwdonly`` (ratio 1 at D 1408, 1664, 1792), ``fchunked`` at k
    2-8, or none (JAX's jnp reference)."""
    for ratio in (1, 2, 4):
        F = ratio * D
        for T in (4096, 16384, 131072):
            want = JM.fused_mlp_block(_shaped(T, D), None, None, _shaped(D, F), None,
                                      _shaped(F, D), None)
            assert tiers.mlp_tier(T, D, F) == want, (T, D, F)


# --- the half-blocks against JAX's kernels ---

def _mlp_arrays(T, D, F, seed):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((T, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, F)), 0.1 * r.standard_normal(F),
        F ** -0.5 * r.standard_normal((F, D)), 0.1 * r.standard_normal(D),
        r.standard_normal((T, D)))]


def _port_grads(arrays, dtype):
    """The port's half-block over its leaves (x in ``dtype``, 2-D weights in
    nn.Linear's layout) through autograd: (out, gradients in JAX's layout)."""
    *args, dout = [torch.from_numpy(a) for a in arrays]
    leaves = [args[0].to(dtype)] + [a.t().contiguous() if a.dim() == 2 else a for a in args[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    out = TM.fused_mlp_block(*leaves)
    out.backward(dout.to(out.dtype))
    grads = [(a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
             for i, a in enumerate(leaves)]
    return out.detach().float().numpy(), grads


def _jax_grads(arrays, dtype):
    *args, dout = arrays
    dt = getattr(jnp, dtype)
    y, vjp = jax.vjp(JM.fused_mlp_block, jnp.asarray(args[0], dt),
                     *(jnp.asarray(a) for a in args[1:]))
    grads = vjp(jnp.asarray(dout, dt))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,F,tier,kernel", [
    (128, SD3_D, 4 * SD3_D, ("fchunked", 4), "_fused_partial_fwd_call"),
    (128, 1408, 1408, ("fwdonly", 1), "_fused_fwd_call")], ids=["fchunked-d1536", "fwdonly-d1408"])
def test_wide_half_block_matches_jax(interpret, T, D, F, tier, kernel, dtype):
    """JAX's ``fused_mlp_block`` takes its tier past D 1344 (k partial
    kernels ``_partial_fwd_kernel`` or the one-shot ``_fwd_kernel``, then
    XLA's backward) and so does the port: its plain K6f chunks or K1f, and
    K1b's plain chain; forward and seven gradients."""
    assert tiers.mlp_tier(T, D, F) == tier
    arrays = _mlp_arrays(T, D, F, seed=5)
    calls = []
    real = getattr(JM, kernel)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, kernel, lambda *a: calls.append(1) or real(*a))
        want_out, want = _jax_grads(arrays, dtype)
    assert len(calls) == tier[1]  # JAX ran its kernel once per chunk
    got_out, got = _port_grads(arrays, getattr(torch, dtype))
    _close(got_out, want_out, dtype, "out")
    for name, g, w in zip(MLP_NAMES, got, want):
        _close(g, w, dtype, f"gradient of {name}")


# --- a depth-1 DiT at SD3-Medium's width ---

def _jax_model(dtype=jnp.float32):
    return JaxDiT(img_size=32, patch_size=4, embed_dim=SD3_D, depth=1, num_heads=SD3_H,
                  time_embed_dim=TDIM, dtype=dtype, data_format="NHWC")


@functools.lru_cache(maxsize=1)
def _variables(seed=0):
    """The JAX model's variable tree (its structure from ``init`` traced
    with ``eval_shape``, which compiles nothing) filled from numpy: weights
    at fan-in^-1/2, LN scales 1 + 0.1 n, every other vector 0.1 n."""
    x0 = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(_jax_model().init, jax.random.PRNGKey(seed), x0, jnp.zeros((1,)), x0)
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        n = r.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return n * np.float32(np.prod(leaf.shape[:-1]) ** -0.5)
        return n * np.float32(0.1) + np.float32("scale" in jax.tree_util.keystr(path))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_model(variables):
    model = DDDMDiT(img_size=32, patch_size=4, embed_dim=SD3_D, depth=1, num_heads=SD3_H,
                    time_embed_dim=TDIM, dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=4))
    return model


def test_state_dict_from_jax_carries_d1536_weights():
    """Every leaf of a JAX block at D 1536 reaches the port's model unchanged
    (the dense kernels transposed to nn.Linear's layout), and back."""
    variables = _variables()
    model = _port_model(variables)
    params, block = variables["params"], variables["params"]["block_0"]
    named = dict(model.named_parameters())
    assert named["blocks.0.ff.net.0.weight"].shape == (4 * SD3_D, SD3_D)
    for key, leaf in (("blocks.0.attn.qkv.weight", block["attn"]["qkv"]["kernel"].T),
                      ("blocks.0.attn.proj.weight", block["attn"]["proj"]["kernel"].T),
                      ("blocks.0.ff.net.0.weight", block["ff_in"]["kernel"].T),
                      ("blocks.0.ff.net.2.weight", block["ff_out"]["kernel"].T),
                      ("blocks.0.ff.net.2.bias", block["ff_out"]["bias"])):
        assert np.array_equal(named[key].detach().numpy(), leaf), key
    back = jax_tree_from_state_dict(model.state_dict(), patch_size=4)["params"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                 jax.tree_util.tree_leaves_with_path(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), jax.tree_util.keystr(path)


def _step_inputs(seed=2):
    r = np.random.default_rng(seed)
    shape = (B, 32, 32, 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_step(variables, inputs):
    model = _jax_model()
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


def _port_step(variables, inputs):
    model = _port_model(variables)
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


def test_depth1_d1536_dit_matches_jax(interpret):
    """A depth-1 DiT at D 1536 over 24 heads, 32 px, fp32: the forward on 4
    images to 1e-4, then one training step (B = 2 x m = 2, injected t, eps,
    xi): the loss terms to 1e-4 relative and every gradient leaf to 1e-4
    with the absolute part at 1e-5 of its largest entry. Both packages take
    the third rung around K7 for attention and the F-chunked MLP at k 8 (as
    at the trainer's 2048 images; k 4 below 256 rows)."""
    N = 64
    assert tiers.attention_tier(B * M, N, SD3_D, SD3_H) is None
    assert tiers.core_tier(B * M, N, SD3_D, SD3_H) == "K7"
    assert tiers.mlp_tier(B * M * N, SD3_D, 4 * SD3_D) == ("fchunked", 8)
    variables = _variables()
    r = np.random.default_rng(1)
    xt, xi = (r.standard_normal((4, 32, 32, 3)).astype(np.float32) for _ in range(2))
    t = r.uniform(0, 1, 4).astype(np.float32)
    want = np.asarray(_jax_model().apply(variables, xt, t, xi))
    with torch.inference_mode():
        got = _port_model(variables)(*(torch.from_numpy(a) for a in (xt, t, xi))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    inputs = _step_inputs()
    want_m, want_g = _jax_step(variables, inputs)
    got_m, got_g = _port_step(variables, inputs)
    assert set(got_g) == set(want_g)
    for k in ("loss", "confidence", "interaction"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4, err_msg=k)
    for path, w in want_g.items():
        np.testing.assert_allclose(got_g[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=path)


def test_train_and_generate_clis_at_d1536_on_cpu(tmp_path, monkeypatch):
    """``--embed-dim 1536 --depth 1 --heads 24`` on 4 synthetic images: the
    trainer's batch 2 x m 2 (256 rows) runs the F-chunked MLP at k 8 and the
    third rung around K7 (plain versions on the CPU); its sampler and
    generate_torch sample 2 images (128 rows: k 4) from the checkpoint."""
    seen = {"mlp": set(), "core": set()}
    real_mlp, real_core = tiers.mlp_tier, tiers.core_tier
    monkeypatch.setattr(tiers, "mlp_tier", lambda *a: seen["mlp"].add(real_mlp(*a))
                        or real_mlp(*a))
    monkeypatch.setattr(tiers, "core_tier", lambda *a: seen["core"].add(real_core(*a))
                        or real_core(*a))
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=4))
    result = cli.main(["--synthetic", "--epochs", "1", "--batch", "2", "--m", "2",
                       "--embed-dim", str(SD3_D), "--depth", "1", "--heads", str(SD3_H),
                       "--time-embed", "16", "--sample-batch", "2", "--sample-steps", "1",
                       "--log-every", "1", "--device", "cpu", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert not any(result["launches"]["train"].values())  # CPU: the plain versions
    assert seen == {"mlp": {("fchunked", 8), ("fchunked", 4)}, "core": {"K7"}}
    seen["mlp"].clear()
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, 32, 32, 3) and np.isfinite(samples).all()
    assert seen["mlp"] == {("fchunked", 4)}


def test_sd3_medium_width_model_size():
    """``--embed-dim 1536 --depth 24 --heads 24`` at patch 4 and 32 px (the
    card's 7o trainer) holds 683.04M parameters (meta tensors: no memory)."""
    model = build_model({"embed_dim": SD3_D, "depth": SD3_DEPTH, "heads": SD3_H}, "meta")
    assert round(sum(p.numel() for p in model.parameters()) / 1e6, 2) == 683.04
    assert model.blocks[0].ff.net["0"].weight.shape == (4 * SD3_D, SD3_D)


# --- the card's path on meta tensors ---

class Launched(Exception):
    pass


class _Library:
    """Stands in for the kernel library on meta tensors: records each entry
    point's name and arguments and reports success."""

    def __init__(self):
        self.calls = []

    @property
    def names(self):
        return [name for name, _ in self.calls]

    def ln_products(self):
        """``(name, T, K, N, epi)`` of each LN-prologue launch, WMMA or wgmma
        (both take T, K, N and the epilogue code after their eight pointers)."""
        return [(name, *args[8:12]) for name, args in self.calls
                if name in ("ddm_ln_gemm", "ddm_wg_ln_gemm")]

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture()
def card_library(monkeypatch):
    """``uses_kernel`` answering True and the launchers of ``ops/gemm.py``
    reaching a recording library: the card's path, shapes only."""
    lib = _Library()
    monkeypatch.setattr(TM, "uses_kernel", lambda *t: True)
    monkeypatch.setattr(TM.gemm, "load_library", lambda: lib)
    monkeypatch.setattr(TM.gemm, "current_stream", lambda device: 0)
    monkeypatch.setattr(TM.gemm, "_sms", lambda device: 132)
    return lib


# K1b's chain: the wgmma recompute, dW2 (+ db2), dh (+ db1), dW1, dy, then
# the LayerNorm backward
K1B_CHAIN = ["ddm_wg_ln_gemm", "ddm_wg_expert_tn", "ddm_wg_expert_nn", "ddm_wg_expert_tn",
             "ddm_wg_expert_nn", "ddm_ln_bwd"]


def _forward_chain(tier):
    """The launches of the card's forward in ``tier``: K1f's two wgmma
    products, or k K6f chunks of the wgmma LN-prologue product and the
    partial product."""
    if tier[0] == "fchunked":
        return ["ddm_wg_ln_gemm", "ddm_wg_gemm_partial"] * tier[1]
    return ["ddm_wg_ln_gemm", "ddm_wg_gemm_residual"]


def _ln_products(T, D, F, tier):
    """The LN-prologue launches of the card's forward and backward in
    ``tier`` as ``(name, T, K, N, epi)``: each K6f chunk takes F // k of
    the hidden columns with the GELU epilogue, K1f all F, and K1b's
    recompute all F with the GELU-gradient epilogue."""
    if tier[0] == "fchunked":
        fwd = [("ddm_wg_ln_gemm", T, D, F // tier[1], TM.gemm.EPI_GELU)] * tier[1]
    else:
        fwd = [("ddm_wg_ln_gemm", T, D, F, TM.gemm.EPI_GELU)]
    return fwd + [("ddm_wg_ln_gemm", T, D, F, TM.gemm.EPI_GELU_GRAD)]


@pytest.mark.parametrize("T,D,F,tier", [
    (4096, 1408, 1408, ("fwdonly", 1)), (131072, 1536, 6144, ("fchunked", 8)),
    (4096, 1536, 6144, ("fchunked", 8)), (131072, 2048, 8192, ("fchunked", 8)),
    (16384, 3072, 6144, ("fchunked", 8)), (131072, 4096, 4096, ("fchunked", 8))])
def test_card_runs_the_mlp_half_block_past_1344(card_library, T, D, F, tier):
    """On the card the MLP half-block past D 1344 passes the port's checks
    and reaches every launch of its chains: K1f's two wgmma products in the
    ``fwdonly`` tier, the k K6f chunks in the ``fchunked`` tier, and K1b's
    chain (the backward of both) through its five wgmma products and the
    LayerNorm backward. No refusal is left. Meta tensors: only shapes are
    read."""
    assert tiers.mlp_tier(T, D, F) == tier
    x = torch.empty((T, D), dtype=torch.bfloat16, device="meta")
    w = [torch.empty(s, device="meta") for s in ((D,), (D,), (F, D), (F,), (D, F), (D,))]
    assert TM.fused_mlp_block(x, *w).shape == (T, D)
    assert card_library.names == _forward_chain(tier)
    grads = TM.mlp_block_bwd(x, *w, torch.empty_like(x))
    assert [tuple(g.shape) for g in grads] == [(T, D), (D,), (D,), (F, D), (F,), (D, F), (D,)]
    assert card_library.names == _forward_chain(tier) + K1B_CHAIN
    assert card_library.ln_products() == _ln_products(T, D, F, tier)


@pytest.mark.parametrize("D", range(1408, 4097, 128))
def test_card_refuses_no_mlp_tier_past_1344(card_library, D):
    """At every D % 128 == 0 from 1408 to 4096, MLP ratios 1, 2 and 4 and
    the trainer's and sampler's row counts, wherever the JAX ladder runs a
    kernel tier the card's forward and K1b's chain reach every launch (meta
    tensors, ``uses_kernel`` answering True); where it has none, the plain
    versions run to their output with no launch."""
    for ratio in (1, 2, 4):
        F = ratio * D
        for T in (4096, 16384, 131072):
            x = torch.empty((T, D), dtype=torch.bfloat16, device="meta")
            w = [torch.empty(s, device="meta") for s in ((D,), (D,), (F, D), (F,), (D, F), (D,))]
            card_library.calls.clear()
            tier = tiers.mlp_tier(T, D, F)
            assert TM.fused_mlp_block(x, *w).shape == (T, D)
            if tier is None:
                assert card_library.names == []
                continue
            TM.mlp_block_bwd(x, *w, torch.empty_like(x))
            assert card_library.names == _forward_chain(tier) + K1B_CHAIN
            assert card_library.ln_products() == _ln_products(T, D, F, tier)


def test_card_runs_plain_products_around_k7_at_d1536(monkeypatch):
    """At D 1536 over 24 heads (N = 64) the attention half takes the third
    rung, as the JAX ladder does: plain products (JAX's XLA) around K7, not
    the half-block GEMM chain."""
    monkeypatch.setattr(TA, "uses_kernel", lambda *t: True)

    def chain(*a):
        raise AssertionError("the GEMM chain ran")

    def launch(*a):
        raise Launched

    monkeypatch.setattr(TA, "_fwd_chain", chain)
    monkeypatch.setattr(TA, "launch_k7f", launch)
    for B in (2048, 64):
        assert tiers.attention_tier(B, 64, SD3_D, SD3_H) is None
        x = torch.empty((B, 64, SD3_D), dtype=torch.bfloat16, device="meta")
        w = [torch.empty(s, device="meta") for s in ((SD3_D,), (SD3_D,), (3 * SD3_D, SD3_D),
                                                     (3 * SD3_D,), (SD3_D, SD3_D), (SD3_D,))]
        with pytest.raises(Launched):
            TA.fused_attention_block(x, *w, SD3_H)
