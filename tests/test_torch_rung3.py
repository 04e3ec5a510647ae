"""Parity of the JAX ladder's third attention rung in the port with the JAX
package: the standalone attention core K7 (its plain forward and backward
against ``_fused_attention``), the core chooser ``tiers.core_tier`` against
``fused_attention``'s and ``flash_supported``'s decisions, the rung-3
half-block (DiT-L at N = 256 through K7; N = 576 through the plain core),
K8's plain versions at head widths 32 and 128, a depth-1 DiT-L-width model
at 64 px (forward and one training step), ``attention="xla"`` against the
JAX model's ``attention_impl='xla'``, and the trainer and sampler CLIs at
DiT-L width and 64 px.

The JAX kernels run in Pallas interpret mode (``DDM_TPU_PALLAS_INTERPRET=1``,
as ``tests/test_attention.py`` runs them); the port runs the same numpy
inputs on CPU tensors, i.e. its plain versions. The CUDA kernels are held to
those plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import functools
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.flash as JF  # noqa: E402
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
from ddm_tpu_torch.ops import flash as TF  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

# fp32: 1e-4 relative, the absolute part at 1e-5 of the tensor's largest
# entry (each value is a sum over N keys, and an entry near zero carries
# the rounding of the whole sum)
F32_RTOL, F32_ATOL_OF_MAX = 1e-4, 1e-5


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


def _f32_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=F32_ATOL_OF_MAX * float(np.abs(want).max()), err_msg=name)


def _bf16_rule(got, want, name):
    """Two bf16 units in the last place at the largest magnitude and a mean
    error far below one unit: the rule chip_smoke.py holds the kernels to."""
    top = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7), name
    assert err.mean() <= 1e-3, name


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- K7: the standalone core ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,D,H", [(8, 64, 384, 6), (2, 256, 1024, 16)],
                         ids=["packed-g4", "dit-l-n256"])
def test_k7_plain_versions_match_jax_fused_attention(interpret_kernels, dtype, B, N, D, H):
    """JAX's K7 (``_fused_attention``, its custom VJP) against the port's
    plain K7f (:func:`attention_reference`) and K7b
    (:func:`attention_core_bwd_reference`). At (8, 64, 384) the TPU kernel
    packs g = 4 images under its -1e30 block mask; the port attends per
    image. fp32 to 1e-4 (the absolute part scaled by each tensor's largest
    entry); bf16 by the two-unit rule, since both follow one rounding plan."""
    assert JA._choose_blocks(B, N, D)[1] == (4 if N == 64 else 1)
    assert tiers.core_tier(B, N, D, H) == "K7"
    r = np.random.default_rng(B + N)
    q, k, v, do = (r.standard_normal((B, N, D)).astype(np.float32) for _ in range(4))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(lambda a, b, c: JA._fused_attention(a, b, c, H, (D // H) ** -0.5),
                       *(jnp.asarray(a, jd) for a in (q, k, v)))
    want = [np.asarray(out, np.float32)] + [np.asarray(g, np.float32)
                                            for g in vjp(jnp.asarray(do, jd))]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    counts = (TA.CORE_LAUNCHES.count, TA.CORE_BWD_LAUNCHES.count)
    got = [TA.attention_core_fwd(tq, tk, tv, H)] + list(TA.attention_core_bwd(tq, tk, tv, tdo, H))
    assert (TA.CORE_LAUNCHES.count, TA.CORE_BWD_LAUNCHES.count) == counts  # CPU: plain
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        g = g.float().numpy()
        if dtype == "float32":
            _f32_close(g, w, name)
        else:
            _bf16_rule(g, w, name)


def test_k7_backward_reference_agrees_with_the_att_writing_core():
    """K7b's plain version is K2b's core without att: the same bits."""
    r = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(r.standard_normal((2, 64, 128)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    att, *grads = TA.attention_core_bwd_att_reference(q, k, v, do, 2)
    assert torch.equal(att, TA.attention_reference(q, k, v, 2))
    for g, w in zip(TA.attention_core_bwd_reference(q, k, v, do, 2), grads):
        assert torch.equal(g, w)


# --- the core chooser ---

WIDTHS = [384, 768, 1024]  # DiT-S, B, L
HEAD_DIMS = [32, 64, 128]


@pytest.fixture()
def jax_core_gates(monkeypatch):
    """JAX's ``fused_attention`` with markers in place of its three cores."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(JA, "_fused_attention", lambda *a: "K7")
    monkeypatch.setattr(JF, "flash_attention_streaming", lambda *a: "K8")
    monkeypatch.setattr(JA, "attention_reference", lambda *a: None)


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("D", WIDTHS)
def test_core_tier_matches_jax_fused_attention(jax_core_gates, D, Dh):
    """Over B in {16, 64, 256, 2048} and N in {64, 256, 576, 1024}: the
    core the port's third rung takes is the one JAX's ``fused_attention``
    takes, and the K8 gate is ``flash_supported``."""
    H = D // Dh
    for B in (16, 64, 256, 2048):
        for N in (64, 256, 576, 1024):
            t = SimpleNamespace(shape=(B, N, D))
            want = JA.fused_attention(t, t, t, H)
            assert tiers.core_tier(B, N, D, H) == want, (B, N)
            assert tiers._k8_gate(B, N, D, H) == JF.flash_supported(B, N, D, H), (B, N)
            if N == 256 and D == 1024 and Dh == 64:
                assert want == "K7" and tiers.attention_tier(B, N, D, H) is None


@pytest.mark.parametrize("Dh", [8, 16, 24, 32, 48, 64, 96, 128, 256, 384])
def test_flash_tile_pickers_match_jax(Dh):
    """The copied VMEM estimators and tile pickers, value for value."""
    assert tiers._heads_per_group(Dh) == JF._heads_per_group(Dh)
    for N in (1024, 2048, 4096, 8192, 16384, 1088):
        assert tiers._tile_sizes(N, Dh) == JF._tile_sizes(N, Dh), N
        assert tiers._windowed_fwd_tiles(N, Dh) == JF._windowed_fwd_tiles(N, Dh), N
        assert tiers._windowed_bwd_tiles(N, Dh) == JF._windowed_bwd_tiles(N, Dh), N
    for B, N, D in ((16, 256, 1024), (2048, 256, 1024), (64, 64, 384), (8, 512, 768)):
        g = JA._choose_blocks(B, N, D)[1]
        assert tiers._core_bwd_block_images(B, N, D, g) == JA._core_bwd_block_images(B, N, D, g)


# --- the rung-3 half-block ---

def _attn_inputs(B, N, D, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, N, D)), 1 + 0.1 * r.standard_normal(D),
            0.1 * r.standard_normal(D), D ** -0.5 * r.standard_normal((D, 3 * D)),
            0.1 * r.standard_normal(3 * D), D ** -0.5 * r.standard_normal((D, D)),
            0.1 * r.standard_normal(D), r.standard_normal((B, N, D))]


def _jax_rung3(arrays, dtype, H):
    *args, dout = [np.asarray(a, np.float32) for a in arrays]

    def f(x, *w):
        return JA.attention_block_reference(x, *w, H, attention_fn=JA.fused_attention)

    out, vjp = jax.vjp(f, jnp.asarray(args[0], dtype), *args[1:])
    grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(out, np.float32)] + [np.asarray(g, np.float32) for g in grads]


def _port_block(arrays, dtype, H):
    *args, dout = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    leaves = [args[0].to(dtype)] + [a.t().contiguous() if a.dim() == 2 else a for a in args[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    out = TA.fused_attention_block(*leaves, H)
    out.backward(dout.to(dtype))
    return [out.detach().float().numpy()] + [
        (a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
        for i, a in enumerate(leaves)]


@pytest.mark.parametrize("B,N,D,H,core", [(2, 256, 1024, 16, "K7"), (1, 576, 384, 6, None)],
                         ids=["dit-l-n256-k7", "n576-plain"])
def test_rung3_half_block_matches_jax(interpret_kernels, monkeypatch, B, N, D, H, core):
    """The port's rung-3 half-block against JAX's XLA half-block around
    ``fused_attention`` (K7 in interpret mode at DiT-L's N = 256; XLA's
    attention at N = 576): forward and all seven gradients, fp32 to 1e-4
    (the absolute part at 1e-5 of each tensor's largest entry), and bf16
    within twice bf16's own noise, e = |JAX bf16 - JAX fp32| (relative
    Frobenius): JAX's bf16 backward rounds dy and the weight gradients to
    bf16 where the port keeps them fp32."""
    assert tiers.attention_tier(B, N, D, H) is None and tiers.core_tier(B, N, D, H) == core
    taken = []
    real = TA.rung3_block_reference
    monkeypatch.setattr(TA, "rung3_block_reference",
                        lambda *a: taken.append(a[-1]) or real(*a))
    arrays = _attn_inputs(B, N, D, seed=N)
    want32 = _jax_rung3(arrays, jnp.float32, H)
    want16 = _jax_rung3(arrays, jnp.bfloat16, H)
    got32 = _port_block(arrays, torch.float32, H)
    got16 = _port_block(arrays, torch.bfloat16, H)
    assert taken == [core, core]
    names = ["out", "dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, g, w in zip(names, got32, want32):
        _f32_close(g, w, name)
    for name, g, w, w32 in zip(names, got16, want16, want32):
        noise = _rel_frob(w, w32)
        assert 0 < noise < 0.1, name
        assert _rel_frob(g, w) <= 2 * noise, name


# --- K8 at head widths 32 and 128 ---

def _jax_flash(q, k, v, do, H, Dh, dtype):
    B, N, _ = q.shape
    scale = Dh ** -0.5
    o, res = JF._flash_fwd(*(jnp.asarray(a, dtype) for a in (q, k, v)), H, scale)
    grads = JF._flash_bwd(H, scale, res, jnp.asarray(do, dtype))
    hp = JF._heads_per_group(Dh)  # lse is (B * H / hp, N, hp)
    lse = np.asarray(res[4]).reshape(B, H // hp, N, hp).transpose(0, 1, 3, 2).reshape(B, H, N)
    return np.asarray(o, np.float32), lse, [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Dh,H", [(32, 4), (128, 2)])
def test_plain_k8_matches_jax_at_head_widths_32_and_128(interpret_kernels, Dh, H, dtype):
    """N = 1024: JAX's single-pass K8 at Dh = 32 (four heads per 128-lane
    group) and 128 (one) against the port's plain K8f/K8b, through
    ``flash_attention``'s autograd. lse to 1e-5 relative; o, dq, dk, dv in
    fp32 to 1e-4 (the absolute part at 1e-5 of each tensor's largest
    entry), in bf16 by the two-unit rule."""
    assert TF.flash_supported(1024, Dh) and JF.flash_supported(1, 1024, H * Dh, H)
    r = np.random.default_rng(Dh)
    q, k, v, do = (r.standard_normal((1, 1024, H * Dh)).astype(np.float32) for _ in range(4))
    wo, wlse, wgrads = _jax_flash(q, k, v, do, H, Dh, getattr(jnp, dtype))
    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
    o = TF.flash_attention(*leaves, H)
    o.backward(torch.from_numpy(do).to(td))
    _, lse = TF.flash_attention_fwd(*(t.detach() for t in leaves), H)
    np.testing.assert_allclose(lse.numpy(), wlse, rtol=1e-5, atol=0)
    got = [o.detach()] + [t.grad for t in leaves]
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, [wo, *wgrads]):
        g = g.float().numpy()
        if dtype == "float32":
            _f32_close(g, w, name)
        else:
            _bf16_rule(g, w, name)


# --- whole models ---

L64 = dict(img=64, patch=4, dim=1024, depth=1, heads=16, tdim=32)
SMALL = dict(img=16, patch=4, dim=128, depth=2, heads=2, tdim=32)
BETA, LAM = 0.1, 1.0


def _jax_model(cfg, dtype, **kw):
    return JaxDiT(img_size=cfg["img"], patch_size=cfg["patch"], embed_dim=cfg["dim"],
                  depth=cfg["depth"], num_heads=cfg["heads"], time_embed_dim=cfg["tdim"],
                  dtype=dtype, data_format="NHWC", **kw)


def _port_model(cfg, variables, dtype, **kw):
    model = DDDMDiT(img_size=cfg["img"], patch_size=cfg["patch"], embed_dim=cfg["dim"],
                    depth=cfg["depth"], num_heads=cfg["heads"], time_embed_dim=cfg["tdim"],
                    dtype=dtype, **kw)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=cfg["patch"]))
    return model


def _variables(cfg, seed):
    x0 = jnp.zeros((1, cfg["img"], cfg["img"], 3))
    variables = _jax_model(cfg, jnp.float32).init(jax.random.PRNGKey(seed), x0, jnp.zeros((1,)),
                                                  x0)
    r = np.random.default_rng(seed)  # non-trivial LN params and biases
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)


def _step_inputs(cfg, B, M, seed):
    r = np.random.default_rng(seed)
    shape = (B, cfg["img"], cfg["img"], 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_step(cfg, variables, inputs, dtype, **kw):
    model = _jax_model(cfg, dtype, **kw)
    x0, t, eps, xi = inputs
    B, M = xi.shape[:2]

    def loss_fn(params):
        xt = jnp.repeat(jax_marginal(x0, t, eps), M, axis=0)
        out = model.apply({"params": params}, xt, jnp.repeat(t, M),
                          xi.reshape((B * M,) + x0.shape[1:]), method="tokens")
        target = jax_patchify(x0, cfg["patch"]).reshape(B, -1)
        conf, inter = jax_energy(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=0.0))
        return weight * (conf - (LAM / (2.0 * (M - 1))) * inter), out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(out, np.float32), {
        jax.tree_util.keystr(p): np.asarray(g, np.float32)
        for p, g in jax.tree_util.tree_leaves_with_path(grads)}


def _port_step(cfg, variables, inputs, dtype, **kw):
    model = _port_model(cfg, variables, dtype, **kw)
    outputs = []

    def tokens(*a):
        outputs.append(model.tokens(*a))
        return outputs[-1]

    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    loss, _ = distributional_training_step(
        tokens, x0, m=xi.shape[1], beta=BETA, lam=LAM, w_bias=0.0, t=t, eps=eps, xi=xi,
        target_transform=lambda a: patchify_images(a, cfg["patch"]))
    loss.backward()
    named = dict(model.named_parameters())
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=cfg["patch"])["params"]
    return float(loss.detach()), outputs[0].detach().float().numpy(), {
        jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _compare_steps(got32, want32, got16, want16):
    """fp32: the loss to 1e-5 relative, the outputs and every gradient leaf
    to 1e-4 (the absolute part at 1e-5 of its largest entry); bf16: the loss,
    outputs and each gradient within twice bf16's own noise on this step,
    e = |JAX bf16 - JAX fp32| (relative Frobenius for arrays)."""
    (loss, out, grads), (wloss, wout, wgrads) = got32, want32
    np.testing.assert_allclose(loss, wloss, rtol=1e-5)
    _f32_close(out, wout, "tokens")
    assert set(grads) == set(wgrads)
    for path, w in wgrads.items():
        _f32_close(grads[path], w, path)
    (loss16, out16, grads16), (wloss16, wout16, wgrads16) = got16, want16
    assert abs(loss16 - wloss16) <= 2 * abs(wloss16 - wloss) + 1e-5 * abs(wloss)
    assert _rel_frob(out16, wout16) <= 2 * _rel_frob(wout16, wout)
    for path, w in wgrads16.items():
        noise = _rel_frob(w, wgrads[path])
        assert 0 < noise < 0.1, path
        assert _rel_frob(grads16[path], w) <= 2 * noise, path


@pytest.fixture(scope="module")
def dit_l64():
    """A depth-1 DiT-L-width model (D 1024, 16 heads) at 64 px (N = 256),
    non-trivial LN params and biases, and one step's inputs (B 1 x m 2)."""
    return _variables(L64, seed=7), _step_inputs(L64, 1, 2, seed=8)


def test_dit_l_at_64_px_forward_and_step_match_jax(dit_l64, monkeypatch):
    """The JAX ladder's third rung with K7 (interpret mode) in both packages:
    JAX's half-block falls through to rung 3 (``attention_tier`` None at
    (2, 256, 1024, 16)) and ``fused_attention`` takes K7; the port's
    rung-3 Function takes the same core. Forward and one training step."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    jax_cores, port_cores = [], []
    real_jax, real_port = JA._fused_attention, TA.rung3_block_reference
    monkeypatch.setattr(JA, "_fused_attention", lambda *a: jax_cores.append("K7") or real_jax(*a))
    monkeypatch.setattr(TA, "rung3_block_reference",
                        lambda *a: port_cores.append(a[-1]) or real_port(*a))
    variables, inputs = dit_l64
    assert tiers.attention_tier(2, 256, 1024, 16) is None
    want32 = _jax_step(L64, variables, inputs, jnp.float32)
    want16 = _jax_step(L64, variables, inputs, jnp.bfloat16)
    got32 = _port_step(L64, variables, inputs, torch.float32)
    got16 = _port_step(L64, variables, inputs, torch.bfloat16)
    assert jax_cores and set(port_cores) == {"K7"}
    _compare_steps(got32, want32, got16, want16)


@pytest.fixture(scope="module")
def small_setup():
    return _variables(SMALL, seed=9), _step_inputs(SMALL, 2, 4, seed=10)


def test_attention_xla_matches_jax_attention_impl_xla(small_setup):
    """``attention="xla"``: the unfused attention half (fp32 LN, bf16 Dense
    with its bias, plain attention core, the residual in the stream dtype)
    against the JAX model's ``attention_impl='xla'`` (its MLP half fused in
    both), forward and one training step, fp32 and bf16."""
    variables, inputs = small_setup
    want32 = _jax_step(SMALL, variables, inputs, jnp.float32, attention_impl="xla")
    want16 = _jax_step(SMALL, variables, inputs, jnp.bfloat16, attention_impl="xla")
    got32 = _port_step(SMALL, variables, inputs, torch.float32, attention="xla")
    got16 = _port_step(SMALL, variables, inputs, torch.bfloat16, attention="xla")
    _compare_steps(got32, want32, got16, want16)


def test_attention_flash_equals_auto_bit_for_bit(small_setup, monkeypatch):
    """``attention="flash"`` is ``"auto"`` (``ddm_tpu/models/dit.py:357``):
    the same half-block calls, the same bits, forward and gradients; and
    ``"xla"`` goes around the fused attention half-block."""
    variables, inputs = small_setup
    calls = []
    real = TA.fused_attention_block
    import ddm_tpu_torch.models.dit as TD
    monkeypatch.setattr(TD, "fused_attention_block", lambda *a: calls.append(1) or real(*a))
    runs = {}
    for impl in ("auto", "flash", "xla"):
        calls.clear()
        loss, out, grads = _port_step(SMALL, variables, inputs, torch.bfloat16, attention=impl)
        runs[impl] = (loss, out, grads, len(calls))
    assert runs["auto"][3] == runs["flash"][3] == SMALL["depth"] and runs["xla"][3] == 0
    assert runs["flash"][0] == runs["auto"][0]
    np.testing.assert_array_equal(runs["flash"][1], runs["auto"][1])
    for path, g in runs["auto"][2].items():
        np.testing.assert_array_equal(runs["flash"][2][path], g)
    with pytest.raises(ValueError, match="attention must be one of"):
        build_model({"attention": "sdpa"}, device="meta")


def test_train_and_generate_clis_at_dit_l_width_and_64_px_on_cpu(tmp_path, monkeypatch):
    """--embed-dim 1024 --depth 1 --heads 16 --image-size 64 on 4 synthetic
    images: the trainer's batch 2 x m 2 (4 images of N = 256) and the
    sampler's 2 images have no half-block tier and take the third rung
    around K7, as the JAX ladder does (plain versions on the CPU); then
    generate_torch samples from the checkpoint."""
    cores = []
    real = tiers.core_tier
    monkeypatch.setattr(tiers, "core_tier", lambda *a: cores.append((a, real(*a))) or real(*a))
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=4))
    result = cli.main(["--synthetic", "--epochs", "1", "--batch", "2", "--m", "2",
                       "--embed-dim", "1024", "--depth", "1", "--heads", "16", "--image-size",
                       "64", "--time-embed", "16", "--sample-batch", "2", "--sample-steps", "1",
                       "--log-every", "1", "--device", "cpu", "--out", str(tmp_path)])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert history["step"] == [1, 2] and np.isfinite(history["loss"]).all()
    assert not any(result["launches"]["train"].values())  # CPU: the plain versions
    assert {c for _, c in cores} == {"K7"} and ((4, 256, 1024, 16), "K7") in cores
    cores.clear()
    npz = tmp_path / "s.npz"
    generate_torch.main(["--ckpt", str(tmp_path), "--n", "2", "--steps", "2", "--device", "cpu",
                         "--out", "", "--npz", str(npz)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (2, 64, 64, 3) and np.isfinite(samples).all()
    assert set(cores) == {((2, 256, 1024, 16), "K7")}


@pytest.mark.parametrize("flags", [["--image-size", "96"], ["--attention", "xla"],
                                   ["--image-size", "128", "--heads", "2"]],
                         ids=["96px", "attention-xla", "128px-dh32"])
def test_trainer_runs_what_it_refused(tmp_path, monkeypatch, flags):
    """--image-size 96 (N = 576: the plain core, as JAX runs XLA's),
    --attention xla, and K8 at Dh = 32 (128 px, D 64 over 2 heads) train on
    2 synthetic images on the CPU and sample."""
    monkeypatch.setattr(cli, "CIFAR10DataConfig",
                        functools.partial(CIFAR10DataConfig, synthetic_size=2))
    cli.main(["--synthetic", "--epochs", "1", "--batch", "2", "--m", "2", "--embed-dim", "64",
              "--depth", "1", "--heads", "2", "--time-embed", "16", "--sample-batch", "1",
              "--sample-steps", "1", "--device", "cpu", "--out", str(tmp_path), *flags])
    history = json.loads((tmp_path / "train_metrics.json").read_text())
    assert np.isfinite(history["loss"]).all()
    cfg = json.loads((tmp_path / "config.json").read_text())
    model = build_model(cfg, device="meta")
    assert model.blocks[0].attention == cfg["attention"]


def test_card_refuses_only_shapes_listed_in_roadmap(monkeypatch):
    """On the card (``uses_kernel`` answering True) the half-block raises,
    before any launch, only where the JAX package runs a kernel the port
    lacks; no shape here does any more. Every shape passes the port's checks
    and reaches its first launch: K7 at Dh 24 (D 768 over 32 heads) and at
    DiT-XL's Dh 72 (D 1152, N = 256), K8 at Dh 16 (D 256 over 16 heads, N =
    1024), the half-block tiers at DiT-XL's 32-px shapes (split: K2f and
    K4), at Dh 24 (DiT-S at --heads 16, fused) and at Dh 16 (--heads 24,
    split); past the half-block GEMMs' widths (D 1536, past 1344) the third
    rung's plain products reach K7, and at D 480, 1472 and 1600 (no GEMM,
    no core: JAX runs XLA alone) they run to their output with no kernel.
    Meta tensors: only shapes are read."""
    monkeypatch.setattr(TA, "uses_kernel", lambda *t: True)

    class Launched(Exception):
        pass

    def launch(*a):
        raise Launched

    monkeypatch.setattr(TA, "_fwd_chain", launch)
    monkeypatch.setattr(TA, "launch_k7f", launch)
    monkeypatch.setattr(TF, "launch_k8f", launch)

    def block(B, N, D, H):
        x = torch.empty((B, N, D), dtype=torch.bfloat16, device="meta")
        w = [torch.empty(s, device="meta") for s in ((D,), (D,), (3 * D, D), (3 * D,),
                                                     (D, D), (D,))]
        return TA.fused_attention_block(x, *w, H)

    for B, N, D, H, tier, core, outcome in (
            (2, 256, 768, 32, None, "K7", Launched),
            (1, 1024, 256, 16, None, "K8", Launched),
            (16, 256, 1152, 16, None, "K7", Launched),
            (2048, 64, 1152, 16, "split", "K7", Launched),
            (64, 256, 1152, 16, None, "K7", Launched),
            (8, 64, 384, 16, "fused", "K7", Launched),
            (2048, 64, 384, 24, "split", "K7", Launched),
            (2048, 64, 1536, 16, None, "K7", Launched),
            (256, 64, 480, 6, None, None, None),
            (256, 64, 1472, 8, None, None, None),
            (256, 64, 1600, 16, None, None, None)):
        assert tiers.attention_tier(B, N, D, H) == tier and tiers.core_tier(B, N, D, H) == core
        if outcome is None:
            assert block(B, N, D, H).shape == (B, N, D)
            continue
        with pytest.raises(outcome):
            block(B, N, D, H)
