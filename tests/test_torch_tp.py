"""Parity of the port's dense tensor-parallel path with the JAX package's, on
the CPU:

- the MLP partial's plain versions (K6f's and K6b's) against
  ``fused_mlp_partial`` and its VJP, whose Pallas kernels
  (``_partial_fwd_kernel``, ``_partial_bwd_kernel``) run in interpret mode;
- ``fused_attention`` on three separate q, k, v against JAX's (K7 in
  interpret mode where its gate takes it, else XLA's attention);
- ``_TPAttention`` and the whole tensor-parallel model (``DDDMDiT(tp=2,
  tp_axis=None)``): forward, and the energy loss's gradients on injected t,
  eps and xi;
- the weights of a tp = 2 tree carried across both ways, and the port's
  ``DIT_TP_RULES`` shards against JAX's ``tree_shardings`` on the 8-device
  virtual mesh.

The same numpy inputs go to both packages; the port runs on CPU tensors,
i.e. its plain versions. fp32 is held to rtol 1e-4 with the absolute part
at 1e-4 of each tensor's largest entry (fp32 sums in another order; an
entry near zero carries the rounding of its whole sum). The multi-rank
steps are in ``tests/test_torch_tp_dist.py``; the kernels on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import _TPAttention  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.ops.energy import fused_energy_terms as jax_energy  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
from ddm_tpu.parallel import DIT_TP_RULES as JAX_TP_RULES  # noqa: E402
from ddm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from ddm_tpu.parallel import tree_shardings  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, DiTBlock, patchify_images  # noqa: E402
from ddm_tpu_torch.models.factory import build_model  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.parallel import (  # noqa: E402
    gather_state_dicts,
    make_mesh,
    shard_state_dict,
    spec_for_name,
)
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

F32_RTOL, F32_ATOL_OF_MAX = 1e-4, 1e-4
# bf16 partial and gradients: both sides round at the same points, but a
# flipped rounding of one bf16 intermediate (y, g, dh) moves single entries
# by a bf16 unit of one term (tests/test_torch_backward.py's rule)
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


def _f32_close(got, want, name, scale=None):
    """fp32 rule; ``scale`` (default: the largest entry of ``want``) sets the
    absolute part."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL_OF_MAX * scale,
                               err_msg=name)


def _k_bias(path: str) -> bool:
    """The k projection's bias: softmax over the keys is unchanged by adding
    one vector to every key, so its gradient is zero but for rounding, in
    both packages, and is held against the q bias gradient's scale."""
    return path.endswith("['k']['bias']")


def _bf16_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=BF16_TOL["rtol"],
                               atol=BF16_TOL["atol"] * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


def _rel_frob(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


# --- the MLP partial: K6f's and K6b's plain versions ---

PARTIAL = dict(T=128, D=128, F=256)  # a tp = 2 shard of D 128's hidden 512


def _partial_inputs(T, D, F, seed=0):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((T, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, F)), 0.1 * r.standard_normal(F),
        F ** -0.5 * r.standard_normal((F, D)), r.standard_normal((T, D)))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_partial_and_its_backward_match_jax_kernels(interpret_kernels, monkeypatch, dtype):
    """``fused_mlp_partial`` (JAX: K5/K6f forward, K6b backward in interpret
    mode; the jnp paths raise) against the port's plain versions, called
    directly and through its autograd Function, for an fp32 cotangent."""
    T, D, F = PARTIAL.values()
    assert JM._mlp_kernel_ok(T, D, F) and tiers.mlp_tier(T, D, F) == ("fused", 1)

    def boom(*a, **k):
        raise AssertionError("JAX left its partial kernels")

    monkeypatch.setattr(JM, "mlp_partial_reference", boom)
    monkeypatch.setattr(JM, "_fused_partial_fwdonly", boom)
    *args, do = _partial_inputs(T, D, F)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(JM.fused_mlp_partial, jnp.asarray(args[0], jdt),
                       *(jnp.asarray(a) for a in args[1:]))
    assert out.dtype == jnp.float32
    want = [np.asarray(out)] + [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do))]

    # the port's weights are nn.Linear's (out, in): transpose JAX's (in, out)
    leaves = [torch.from_numpy(args[0]).to(tdt)] + [
        torch.from_numpy(a.T.copy() if a.ndim == 2 else a) for a in args[1:]]
    cot = torch.from_numpy(do)
    direct = [TM.mlp_partial_reference(*leaves), *TM.mlp_partial_bwd_reference(*leaves, cot)]
    leaves = [t.detach().requires_grad_() for t in leaves]
    part = TM.fused_mlp_partial(*leaves)
    part.backward(cot)
    assert part.dtype == torch.float32
    through = [part.detach()] + [t.grad for t in leaves]
    names = ["partial", "dx", "dscale", "dbias", "dw1", "db1", "dw2"]
    for run in (direct, through):
        for name, g, w in zip(names, run, want):
            g = g.float().numpy()
            g = g.T if g.ndim == 2 and name.startswith("dw") else g
            (_f32_close if dtype == "float32" else _bf16_close)(g, w, name)
    for g, h in zip(direct, through):  # the Function runs the plain versions on the CPU
        assert torch.equal(g.to(h.dtype), h)


# --- fused_attention on three separate tensors ---

@pytest.mark.parametrize("dtype,B,N,D,H,core", [
    ("float32", 2, 16, 256, 4, "K7"), ("bfloat16", 2, 16, 256, 4, "K7"),
    ("float32", 2, 16, 192, 3, None)], ids=["k7-float32", "k7-bfloat16", "xla-core-float32"])
def test_fused_attention_matches_jax(interpret_kernels, monkeypatch, dtype, B, N, D, H, core):
    """The port's ``fused_attention`` against JAX's on the same q, k, v:
    K7 in interpret mode at D 256 (the JAX gate's D % 128 = 0), XLA's
    attention at D 192 (the DiT-S --tp 2 local width), where the port runs
    its plain core; forward and the three gradients. XLA's autodiff rounds
    differently from the kernels' plan in bf16, so the plain core is held
    in fp32 only."""
    assert tiers.core_tier(B, N, D, H) == core
    jax_calls = []
    real = JA._fused_attention
    monkeypatch.setattr(JA, "_fused_attention", lambda *a: jax_calls.append(1) or real(*a))
    r = np.random.default_rng(D)
    q, k, v, do = (r.standard_normal((B, N, D)).astype(np.float32) for _ in range(4))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda *a: JA.fused_attention(*a, H), *(jnp.asarray(a, jdt)
                                                                for a in (q, k, v)))
    want = [np.asarray(out, np.float32)] + [np.asarray(g, np.float32)
                                            for g in vjp(jnp.asarray(do, jdt))]
    assert bool(jax_calls) == (core == "K7")
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    o = TA.fused_attention(*leaves, H)
    o.backward(torch.from_numpy(do).to(tdt))
    got = [o.detach()] + [t.grad for t in leaves]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g = g.float().numpy()
        if dtype == "float32":
            _f32_close(g, w, name)
        else:  # two bf16 units at the largest magnitude, a mean far below one
            top = float(np.abs(w).max())
            assert np.abs(g - w).max() <= 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7), name
            assert np.abs(g - w).mean() <= 1e-3, name


# --- _TPAttention and the whole tensor-parallel model ---

@pytest.mark.parametrize("D,H", [(256, 4), (192, 3)], ids=["k7", "xla-core"])
def test_tp_attention_matches_jax(interpret_kernels, D, H):
    """The port's tensor-parallel attention half (one block's
    ``_tp_attention`` with full weights) against ``_TPAttention(tp=2,
    tp_axis=None)``: its output and the gradients of h, the residual and
    every weight, fp32."""
    B, N = 2, 16
    mod = _TPAttention(D, H, tp=2, tp_axis=None, dtype=jnp.float32)
    r = np.random.default_rng(H)
    h, x, dout = (r.standard_normal((B, N, D)).astype(np.float32) for _ in range(3))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x))["params"]
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), params)
    out, vjp = jax.vjp(lambda p, h_, x_: mod.apply({"params": p}, h_, x_), params,
                       jnp.asarray(h), jnp.asarray(x))
    gp, gh, gx = vjp(jnp.asarray(dout))

    block = DiTBlock(D, H, tp=2)
    sd = {"attn.qkv.weight": np.concatenate([params[n]["kernel"].T for n in "qkv"]),
          "attn.qkv.bias": np.concatenate([params[n]["bias"] for n in "qkv"]),
          "attn.proj.weight": params["proj"]["kernel"].T, "attn.proj.bias": params["proj"]["bias"]}
    block.attn.load_state_dict({k[len("attn."):]: torch.from_numpy(np.ascontiguousarray(v))
                                for k, v in sd.items()})
    ht, xt = (torch.from_numpy(a).requires_grad_() for a in (h, x))
    got = block._tp_attention(ht, xt)
    got.backward(torch.from_numpy(dout))
    _f32_close(got.detach().numpy(), np.asarray(out), "out")
    _f32_close(ht.grad.numpy(), np.asarray(gh), "dh")
    _f32_close(xt.grad.numpy(), np.asarray(gx), "dx")
    wq, wk, wv = block.attn.qkv.weight.grad.numpy().reshape(3, D, D)
    bq, bk, bv = block.attn.qkv.bias.grad.numpy().reshape(3, D)
    for n, w, b in zip("qkv", (wq, wk, wv), (bq, bk, bv)):
        _f32_close(w.T, np.asarray(gp[n]["kernel"]), f"d{n}")
        _f32_close(b, np.asarray(gp[n]["bias"]), f"db{n}",
                   scale=float(np.abs(bq).max()) if n == "k" else None)
    _f32_close(block.attn.proj.weight.grad.numpy().T, np.asarray(gp["proj"]["kernel"]), "dproj")
    _f32_close(block.attn.proj.bias.grad.numpy(), np.asarray(gp["proj"]["bias"]), "dbproj")


TP_CFG = dict(img=8, patch=2, dim=256, depth=2, heads=4, tdim=16)
BETA, LAM = 0.1, 1.0


def _jax_model(dtype, tp_axis=None):
    c = TP_CFG
    return JaxDiT(img_size=c["img"], patch_size=c["patch"], embed_dim=c["dim"], depth=c["depth"],
                  num_heads=c["heads"], time_embed_dim=c["tdim"], dtype=dtype,
                  data_format="NHWC", tp=2, tp_axis=tp_axis)


@pytest.fixture(scope="module")
def tp_variables():
    """A tp = 2 JAX tree (separate q, k, v) with LN parameters and biases
    moved off 1 and 0, and one step's inputs (B 2 x m 2)."""
    c = TP_CFG
    x0 = jnp.zeros((1, c["img"], c["img"], 3))
    variables = _jax_model(jnp.float32).init(jax.random.PRNGKey(3), x0, jnp.zeros((1,)), x0)
    r = np.random.default_rng(3)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)
    shape = (2, c["img"], c["img"], 3)
    inputs = (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, 2).astype(np.float32),
              r.standard_normal(shape).astype(np.float32),
              r.standard_normal((2, 2) + shape[1:]).astype(np.float32))
    return variables, inputs


def _jax_step(variables, inputs, dtype):
    model = _jax_model(dtype)
    x0, t, eps, xi = inputs
    B, M = xi.shape[:2]

    def loss_fn(params):
        xt = jnp.repeat(jax_marginal(x0, t, eps), M, axis=0)
        out = model.apply({"params": params}, xt, jnp.repeat(t, M),
                          xi.reshape((B * M,) + x0.shape[1:]), method="tokens")
        target = jax_patchify(x0, TP_CFG["patch"]).reshape(B, -1)
        conf, inter = jax_energy(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=0.0))
        return weight * (conf - (LAM / (2.0 * (M - 1))) * inter), out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(out, np.float32), {
        jax.tree_util.keystr(p): np.asarray(g, np.float32)
        for p, g in jax.tree_util.tree_leaves_with_path(grads)}


def _port_model(variables, dtype):
    c = TP_CFG
    model = DDDMDiT(img_size=c["img"], patch_size=c["patch"], embed_dim=c["dim"], depth=c["depth"],
                    num_heads=c["heads"], time_embed_dim=c["tdim"], dtype=dtype, tp=2)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=c["patch"]))
    return model


def _port_step(variables, inputs, dtype):
    model = _port_model(variables, dtype)
    outputs = []

    def tokens(*a):
        outputs.append(model.tokens(*a))
        return outputs[-1]

    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    loss, _ = distributional_training_step(
        tokens, x0, m=xi.shape[1], beta=BETA, lam=LAM, w_bias=0.0, t=t, eps=eps, xi=xi,
        target_transform=lambda a: patchify_images(a, TP_CFG["patch"]))
    loss.backward()
    tree = jax_tree_from_state_dict({k: p.grad for k, p in model.named_parameters()},
                                    patch_size=TP_CFG["patch"], tp=2)["params"]
    return float(loss.detach()), outputs[0].detach().float().numpy(), {
        jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def test_tp_model_forward_and_step_match_jax(interpret_kernels, tp_variables, monkeypatch):
    """The full tensor-parallel instance against ``DDDMDiT(tp=2,
    tp_axis=None)`` with its kernels in interpret mode (K7 at D 256, the
    partial's K6f/K6b at F 1024): the tokens, the loss to 1e-5 and every
    gradient leaf (JAX's separate q, k, v included), fp32; in bf16 within
    twice bf16's own noise on this step, e = |JAX bf16 - JAX fp32|
    (relative Frobenius)."""
    jax_calls, port_cores = [], []
    real_attn, real_part = JA._fused_attention, JM._fused_partial
    monkeypatch.setattr(JA, "_fused_attention", lambda *a: jax_calls.append("K7") or real_attn(*a))
    monkeypatch.setattr(JM, "_fused_partial", lambda *a: jax_calls.append("K6") or real_part(*a))
    real_core = tiers.core_tier
    monkeypatch.setattr(tiers, "core_tier", lambda *a: port_cores.append(real_core(*a)) or
                        real_core(*a))
    variables, inputs = tp_variables
    want32 = _jax_step(variables, inputs, jnp.float32)
    want16 = _jax_step(variables, inputs, jnp.bfloat16)
    got32 = _port_step(variables, inputs, torch.float32)
    got16 = _port_step(variables, inputs, torch.bfloat16)
    assert {"K7", "K6"} <= set(jax_calls) and set(port_cores) == {"K7"}
    (loss, out, grads), (wloss, wout, wgrads) = got32, want32
    np.testing.assert_allclose(loss, wloss, rtol=1e-5)
    _f32_close(out, wout, "tokens")
    assert set(grads) == set(wgrads) and any("['attn']['q']" in p for p in grads)
    q_bias = lambda path: np.abs(wgrads[path.replace("['k']", "['q']")]).max()  # noqa: E731
    for path, w in wgrads.items():
        _f32_close(grads[path], w, path, scale=q_bias(path) if _k_bias(path) else None)
    (loss16, out16, grads16), (wloss16, wout16, wgrads16) = got16, want16
    assert abs(loss16 - wloss16) <= 2 * abs(wloss16 - wloss) + 1e-5 * abs(wloss)
    assert _rel_frob(out16, wout16) <= 2 * _rel_frob(wout16, wout)
    for path, w in wgrads16.items():
        if _k_bias(path):  # rounding noise in both: small against the q bias's
            assert max(np.abs(w).max(), np.abs(grads16[path]).max()) <= 1e-2 * q_bias(path)
            continue
        noise = _rel_frob(w, wgrads[path])
        assert 0 < noise < 0.1, path
        assert _rel_frob(grads16[path], w) <= 2 * noise, path


# --- weights both ways, and the shard rules ---

def test_tp_weights_carry_over_both_ways(tp_variables):
    """A tp = 2 JAX tree loads into the port's tensor-parallel model (the
    separate q, k, v fused by rows into ``attn.qkv``), and the model's
    ``state_dict`` maps back to the same tree, leaf for leaf, exactly; the
    same ``state_dict`` loads into the replicated model too."""
    variables, _ = tp_variables
    model = _port_model(variables, torch.float32)
    back = jax_tree_from_state_dict(model.state_dict(), patch_size=TP_CFG["patch"], tp=2)
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], np.asarray(w), err_msg=jax.tree_util.keystr(path))
    c = TP_CFG
    plain = DDDMDiT(img_size=c["img"], patch_size=c["patch"], embed_dim=c["dim"],
                    depth=c["depth"], num_heads=c["heads"], time_embed_dim=c["tdim"])
    plain.load_state_dict(model.state_dict())


def test_tp_rules_shard_as_jax_tree_shardings(tp_variables):
    """Each model rank's shard by the port's ``DIT_TP_RULES`` holds, mapped
    to JAX's layout, exactly the slices that JAX's ``DIT_TP_RULES`` give the
    devices of that model index on the (4 data x 2 model) virtual mesh; the
    shards gather back to the full ``state_dict``."""
    variables, _ = tp_variables
    params = jax.tree.map(jnp.asarray, variables["params"])
    mesh = jax_make_mesh(tp=2)
    shardings = tree_shardings(params, mesh, JAX_TP_RULES)
    full = state_dict_from_jax(variables, patch_size=TP_CFG["patch"])
    shards = [shard_state_dict(full, 2, r) for r in range(2)]
    for r in range(2):
        device = mesh.devices[0, r]
        want = jax.tree.map(
            lambda a, s: np.asarray(a)[s.devices_indices_map(a.shape)[device]], params, shardings)
        got = dict(jax.tree_util.tree_leaves_with_path(
            jax_tree_from_state_dict(shards[r], patch_size=TP_CFG["patch"], tp=2)["params"]))
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(got[path], w, err_msg=jax.tree_util.keystr(path))
    back = gather_state_dicts(shards)
    assert back.keys() == full.keys()
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    sharded = {k for k in full if spec_for_name(k)}
    assert sharded == {k for k in full if any(s in k for s in (
        "attn.qkv", "attn.proj.weight", "ff.net.0", "ff.net.2.weight"))}


def test_tp_refusals_and_checks():
    """``--tp 2`` on one rank raises as JAX's ``make_mesh(tp=2)`` on one
    device does; tp must divide the width, the heads and the hidden size;
    ``sp`` and tp with MoE stay refused."""
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        make_mesh(2)
    assert make_mesh(1).dp == 1
    with pytest.raises(ValueError, match="tp must divide"):
        build_model({"tp": 4}, device="meta")  # 6 heads
    for cfg in ({"tp": 2, "sp": True}, {"tp": 2, "moe_experts": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 11"):
            build_model(cfg, device="meta")
    model = build_model({"tp": 2}, device="meta")  # the full instance: full widths
    assert model.blocks[0].attn.qkv.weight.shape == (3 * 384, 384)
    assert model.blocks[0].ff.net["2"].weight.shape == (384, 1536)
