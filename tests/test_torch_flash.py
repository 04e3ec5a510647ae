"""Parity of the port's long-sequence path (kernel K8's plain versions, the
long-sequence attention half-block, a DiT at ``image_size = 128``, the
energy gate) with the JAX package.

The JAX side runs its flash kernels (``ddm_tpu/ops/flash.py``) in Pallas
interpret mode, as ``tests/test_flash.py`` does: the N = 1024 tiers at
every family of head widths (Dh 4, 8 and 16 packed into lanes, 64, 256
and 384), the K/V-windowed tiers forced at N = 2048, and the phantom-head
pad at an odd head count. The port runs the same numpy inputs on CPU
tensors, i.e. its plain versions; the CUDA kernels are held to those on the
card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.energy as JE  # noqa: E402
import ddm_tpu.ops.flash as JF  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.models.dit import patchify_images as jax_patchify  # noqa: E402
from ddm_tpu.ops.losses import sigmoid_weight as jax_sigmoid_weight  # noqa: E402
from ddm_tpu.ops.schedules import forward_marginal_sample as jax_marginal  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT, patchify_images  # noqa: E402
from ddm_tpu_torch.models.factory import build_model  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import energy as TE  # noqa: E402
from ddm_tpu_torch.ops import flash as TF  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402
from ddm_tpu_torch.training import distributional_training_step  # noqa: E402
from ddm_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax  # noqa: E402

DH = 64
# fp32: the relative tolerance of tests/test_flash.py:229-230; the absolute
# part scales with each tensor's largest entry, since every o, dq, dk and dv
# entry is a sum over 1,024 keys and one near zero carries the rounding of
# the whole sum, whose order the two packages' fp32 products choose
F32_RTOL, F32_ATOL_OF_MAX = 1e-4, 1e-4


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")


@pytest.fixture()
def windowed_tiers(interpret_kernels, monkeypatch):
    """Force the K/V-windowed forward and the two-kernel windowed backward
    on N = 2048 with windows and tiles smaller than N, as
    tests/test_flash.py:219-224 does."""
    monkeypatch.setattr(JF, "_tile_sizes", lambda N, Dh: ((0, 0, 0), (0, 0, 0)))
    monkeypatch.setattr(JF, "_windowed_fwd_tiles", lambda N, Dh: (512, 512, 128, 256))
    monkeypatch.setattr(JF, "_windowed_bwd_tiles", lambda N, Dh: (512, 512, 128, 256))


def _inputs(B, N, H, seed, shift=0.0, Dh=DH):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((B, N, H * Dh)).astype(np.float32) for _ in range(4))
    return q + shift, k, v, do


def _jax_flash(q, k, v, do, H, dtype):
    """JAX's K8 forward and its custom-VJP backward, called as the VJP
    calls them: ``(o, lse as (B, H, N), (dq, dk, dv))`` in fp32 numpy."""
    B, N, D = q.shape
    scale = (D // H) ** -0.5
    o, res = JF._flash_fwd(*(jnp.asarray(a, dtype) for a in (q, k, v)), H, scale)
    grads = JF._flash_bwd(H, scale, res, jnp.asarray(do, dtype))
    hp = JF._heads_per_group(D // H)  # lse is (B * H / hp, N, hp)
    lse = np.asarray(res[4]).reshape(B, H // hp, N, hp).transpose(0, 1, 3, 2).reshape(B, H, N)
    return np.asarray(o, np.float32), lse, [np.asarray(g, np.float32) for g in grads]


def _port_flash(q, k, v, do, H, dtype):
    """The port's plain forward and, through ``flash_attention``'s autograd,
    its plain backward."""
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = TF.flash_attention(*leaves, H)
    o.backward(torch.from_numpy(do).to(dtype))
    _, lse = TF.flash_attention_fwd(*(t.detach() for t in leaves), H)
    return (o.detach().float().numpy(), lse.numpy(),
            [t.grad.float().numpy() for t in leaves])


def _bf16_rule(got, want, name):
    """Two bf16 units in the last place at the largest magnitude (one
    flipped rounding of a sum taken in another order) and a mean error far
    below one unit: the rule chip_smoke.py holds the kernels to."""
    top = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7), name
    assert err.mean() <= 1e-3, name


def _f32_rule(got, want, name):
    np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                               atol=F32_ATOL_OF_MAX * float(np.abs(want).max()), err_msg=name)


def _compare_flash(got, want, dtype):
    (o, lse, grads), (wo, wlse, wgrads) = got, want
    np.testing.assert_allclose(lse, wlse, rtol=1e-5, atol=0)
    for name, g, w in zip(("o", "dq", "dk", "dv"), [o, *grads], [wo, *wgrads]):
        if dtype == "float32":
            _f32_rule(g, w, name)
        else:
            _bf16_rule(g, w, name)


@pytest.mark.parametrize("Dh,H", [(DH, 2), (4, 32), (8, 16), (16, 8), (256, 1), (384, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_jax_single_pass(interpret_kernels, dtype, Dh, H):
    """N = 1024 at every family of head widths JAX's K8 takes: at Dh 64 its
    single-pass forward (one k tile, bk = N) and single-kernel backward (cq
    = N); at Dh 4, 8 and 16 heads packed 32, 16 and 8 to a 128-lane group
    (Dh 4's backward through the windowed kernels); at Dh 256 and 384 one
    head a group, its backward in q chunks below N at Dh 384."""
    assert JF.flash_supported(1, 1024, H * Dh, H) and TF.flash_supported(1024, Dh)
    if Dh == DH:
        assert JF._tile_sizes(1024, DH)[0][2] == 1024 and JF._tile_sizes(1024, DH)[1][0] == 1024
    arrays = _inputs(1, 1024, H, seed=0, Dh=Dh)
    want = _jax_flash(*arrays, H, getattr(jnp, dtype))
    TF.FWD_LAUNCHES.reset()
    TF.BWD_LAUNCHES.reset()
    got = _port_flash(*arrays, H, getattr(torch, dtype))
    assert (TF.FWD_LAUNCHES.count, TF.BWD_LAUNCHES.count) == (0, 0)  # CPU: plain versions
    _compare_flash(got, want, dtype)


@pytest.mark.parametrize("Dh,H", [(DH, 2), (16, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_jax_windowed_tiers(windowed_tiers, dtype, Dh, H):
    """N = 2048 through ``_fwd_win_kernel``, ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``: online-softmax state carried across K/V windows,
    dq and dk/dv summed across windows and q chunks; at Dh 64 and at Dh 16
    (8 heads packed into the lanes). q is shifted so the windows' maxima
    differ."""
    arrays = _inputs(1, 2048, H, seed=1, shift=2.0, Dh=Dh)
    want = _jax_flash(*arrays, H, getattr(jnp, dtype))
    _compare_flash(_port_flash(*arrays, H, getattr(torch, dtype)), want, dtype)


def test_plain_flash_odd_head_count_matches_jax_phantom_pad(interpret_kernels):
    """H = 3: JAX pads a phantom zero head to fill its last 128-lane group;
    the port takes the three heads as they are."""
    q, k, v, do = _inputs(1, 1024, 3, seed=2)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    o, vjp = jax.vjp(lambda a, b, c: JF.flash_attention_streaming(a, b, c, 3), jq, jk, jv)
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got_o, _, got_grads = _port_flash(q, k, v, do, 3, torch.float32)
    for name, g, w in zip(("o", "dq", "dk", "dv"), [got_o, *got_grads], want):
        _f32_rule(g, w, name)


def _attn_inputs(B, N, D, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, N, D)), 1 + 0.1 * r.standard_normal(D),
            0.1 * r.standard_normal(D), D ** -0.5 * r.standard_normal((D, 3 * D)),
            0.1 * r.standard_normal(3 * D), D ** -0.5 * r.standard_normal((D, D)),
            0.1 * r.standard_normal(D), r.standard_normal((B, N, D))]


def _jax_block(arrays, dtype, H):
    *args, dout = [np.asarray(a, np.float32) for a in arrays]

    def f(x, *w):
        return JA.fused_attention_block(x, *w, H)

    out, vjp = jax.vjp(f, jnp.asarray(args[0], dtype), *args[1:])
    grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(out, np.float32)] + [np.asarray(g, np.float32) for g in grads]


def _port_block(arrays, dtype, H):
    *args, dout = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]
    # the port's weights are nn.Linear's (out, in): transpose JAX's (in, out)
    leaves = [args[0].to(dtype)] + [a.t().contiguous() if a.dim() == 2 else a for a in args[1:]]
    leaves = [a.detach().requires_grad_() for a in leaves]
    out = TA.fused_attention_block(*leaves, H)
    out.backward(dout.to(dtype))
    return [out.detach().float().numpy()] + [
        (a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
        for i, a in enumerate(leaves)]


def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_long_attention_half_block_matches_jax(interpret_kernels, monkeypatch):
    """N = 1024 (D = 128, H = 2): JAX's half-block falls to rung 3 (XLA
    around ``fused_attention``, which takes the flash tier); the port's to
    the long-sequence half-block. Forward and all seven gradients, in fp32
    (1e-4) and in bf16. JAX's bf16 backward rounds dy and the weight
    gradients to bf16 where the port keeps fp32, so each bf16 result lies
    within twice bf16's own noise of JAX's: e = |JAX bf16 - JAX fp32|."""
    def boom(*a, **k):
        raise AssertionError("JAX took the XLA attention core, not the flash tier")

    monkeypatch.setattr(JA, "attention_reference", boom)
    arrays = _attn_inputs(1, 1024, 2 * DH, seed=3)
    want32 = _jax_block(arrays, jnp.float32, 2)
    want16 = _jax_block(arrays, jnp.bfloat16, 2)
    got32 = _port_block(arrays, torch.float32, 2)
    got16 = _port_block(arrays, torch.bfloat16, 2)
    names = ["out", "dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"]
    for name, g, w in zip(names, got32, want32):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    for name, g, w, w32 in zip(names, got16, want16, want32):
        noise = _rel_frob(w, w32)
        assert 0 < noise < 0.1, name
        assert _rel_frob(g, w) <= 2 * noise, name


CFG = dict(img=128, patch=4, dim=128, depth=2, heads=2, tdim=32)
# the 128-px DiTs held to JAX in fp32: CFG (Dh 64), and depth 1 at Dh 16 (D
# 128 over 8 heads, packed 8 to a lane group in JAX) and Dh 256 (D 256, one head)
DITS_128 = {"dh64": CFG, "dh16": dict(CFG, depth=1, heads=8),
            "dh256": dict(CFG, dim=256, depth=1, heads=1)}
B, M, BETA, LAM = 1, 2, 0.1, 1.0


def _jax_model(dtype, cfg=CFG):
    return JaxDiT(img_size=cfg["img"], patch_size=cfg["patch"], embed_dim=cfg["dim"],
                  depth=cfg["depth"], num_heads=cfg["heads"], time_embed_dim=cfg["tdim"],
                  dtype=dtype, data_format="NHWC")


def _dit_inputs():
    r = np.random.default_rng(4)
    shape = (B, CFG["img"], CFG["img"], 3)
    return (r.uniform(-1, 1, shape).astype(np.float32), r.uniform(0, 1, B).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            r.standard_normal((B, M) + shape[1:]).astype(np.float32))


def _jax_step(variables, inputs, dtype, cfg=CFG):
    """JAX's loss and gradients of one step, with its flash tier and K3 in
    interpret mode, on injected t, eps and xi."""
    model = _jax_model(dtype, cfg)
    x0, t, eps, xi = inputs

    def loss_fn(params):
        xt = jax_marginal(x0, t, eps)
        out = model.apply({"params": params}, jnp.repeat(xt, M, axis=0), jnp.repeat(t, M),
                          xi.reshape((B * M,) + x0.shape[1:]), method="tokens")
        target = jax_patchify(x0, CFG["patch"]).reshape(B, -1)
        conf, inter = JE.fused_energy_terms(out.reshape(B, M, -1), target, BETA)
        weight = jnp.mean(jax_sigmoid_weight(t, bias=0.0))
        return weight * (conf - (LAM / (2.0 * (M - 1))) * inter), out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    return float(loss), np.asarray(out, np.float32), {
        jax.tree_util.keystr(p): np.asarray(g, np.float32)
        for p, g in jax.tree_util.tree_leaves_with_path(grads)}


def _port_step(variables, inputs, dtype, cfg=CFG):
    model = DDDMDiT(img_size=cfg["img"], patch_size=cfg["patch"], embed_dim=cfg["dim"],
                    depth=cfg["depth"], num_heads=cfg["heads"], time_embed_dim=cfg["tdim"],
                    dtype=dtype)
    model.load_state_dict(state_dict_from_jax(variables, patch_size=CFG["patch"]))
    outputs = []

    def tokens(*a):
        outputs.append(model.tokens(*a))
        return outputs[-1]

    x0, t, eps, xi = (torch.from_numpy(a) for a in inputs)
    loss, _ = distributional_training_step(
        tokens, x0, m=M, beta=BETA, lam=LAM, w_bias=0.0, t=t, eps=eps, xi=xi,
        target_transform=lambda a: patchify_images(a, CFG["patch"]))
    loss.backward()
    named = dict(model.named_parameters())
    tree = jax_tree_from_state_dict({k: p.grad for k, p in named.items()},
                                    patch_size=CFG["patch"])["params"]
    return float(loss.detach()), outputs[0].detach().float().numpy(), {
        jax.tree_util.keystr(p): g for p, g in jax.tree_util.tree_leaves_with_path(tree)}


def _dit_128_setup(cfg):
    """A DiT of ``cfg`` at image_size 128 (N = 1024) with non-trivial LN
    params and biases, and one step's injected t, eps and xi."""
    x0 = jnp.zeros((1, cfg["img"], cfg["img"], 3))
    variables = _jax_model(jnp.float32, cfg).init(jax.random.PRNGKey(0), x0, jnp.zeros((1,)),
                                                  x0)
    r = np.random.default_rng(5)
    variables = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.standard_normal(a.shape).astype(np.float32), variables)
    return variables, _dit_inputs()


@pytest.fixture(scope="module")
def dit_128_setup():
    """The depth-2, D = 128 DiT (Dh 64)."""
    return _dit_128_setup(CFG)


def _jax_step_through_flash(setup, dtype, cfg=CFG):
    """JAX's loss, token outputs and gradients through its flash tier (its
    XLA attention core raises if reached) and K3, in interpret mode."""
    def boom(*a, **k):
        raise AssertionError("JAX took the XLA attention core, not the flash tier")

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        mp.setattr(JA, "attention_reference", boom)
        assert JF.flash_supported(B * M, 1024, cfg["dim"], cfg["heads"])
        return _jax_step(*setup, dtype, cfg)


@pytest.fixture(scope="module")
def jax_dit_128_fp32(dit_128_setup):
    return _jax_step_through_flash(dit_128_setup, jnp.float32)


@pytest.fixture(scope="module")
def jax_dit_128_bf16(dit_128_setup):
    return _jax_step_through_flash(dit_128_setup, jnp.bfloat16)


@pytest.mark.parametrize("name", list(DITS_128))
def test_dit_128_forward_loss_and_gradients_match_jax_fp32(request, name):
    """The port's step against JAX's through its flash tier, in fp32: the
    Dh-64 DiT, and depth-1 DiTs at Dh 16 and Dh 256, where the port's
    ladder also takes K8 (its plain versions here)."""
    cfg = DITS_128[name]
    assert tiers.core_tier(B * M, 1024, cfg["dim"], cfg["heads"]) == "K8"
    if name == "dh64":
        setup, (want_loss, want_out, want) = (request.getfixturevalue("dit_128_setup"),
                                              request.getfixturevalue("jax_dit_128_fp32"))
    else:
        setup = _dit_128_setup(cfg)
        want_loss, want_out, want = _jax_step_through_flash(setup, jnp.float32, cfg)
    loss, out, got = _port_step(*setup, torch.float32, cfg)
    assert out.shape == (B * M, 1024, 16 * 3)
    np.testing.assert_allclose(out, want_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=path)


def test_dit_128_bf16_lies_within_bf16_noise_of_jax(dit_128_setup, jax_dit_128_fp32,
                                                    jax_dit_128_bf16):
    """Each bf16 result within 2 e of JAX's bf16 one, e = |JAX bf16 - JAX
    fp32| (relative Frobenius for the outputs and every gradient)."""
    loss32, out32, want32 = jax_dit_128_fp32
    loss16, out16, want16 = jax_dit_128_bf16
    loss, out, got = _port_step(*dit_128_setup, torch.bfloat16)
    assert abs(loss - loss16) <= 2 * abs(loss16 - loss32) + 1e-4 * abs(loss32)
    assert _rel_frob(out, out16) <= 2 * _rel_frob(out16, out32)
    for path, w in want16.items():
        noise = _rel_frob(w, want32[path])
        assert 0 < noise < 0.1, path
        assert _rel_frob(got[path], w) <= 2 * noise, path


GATE_TOKENS = (1024, 1600, 2304, 4096, 9216, 16384)  # 128, 160, 192, 256, 384, 512 px
GATE_HEADS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 96)


@pytest.mark.parametrize("N", GATE_TOKENS)
def test_port_k8_takes_every_shape_the_jax_gate_sends_it(interpret_kernels, N):
    """Over every head width Dh = D / H up to 1152 and head counts from 1 to
    96 (whole 128-lane groups and JAX's phantom-head pad): the port's ladder
    picks K8 exactly where JAX's ``flash_supported`` does, and wherever it
    does, the port's K8 takes the shape, so ``_refuse_unported_core`` never
    raises for K8."""
    for Dh in range(1, 1153):
        for H in GATE_HEADS:
            jax_k8 = JF.flash_supported(2, N, H * Dh, H)
            assert (tiers.core_tier(2, N, H * Dh, H) == "K8") == jax_k8, (N, Dh, H)
            if jax_k8:
                assert TF.flash_supported(N, Dh), (N, Dh, H)
                TA._refuse_unported_core("K8", N, Dh)


def test_port_k8_admits_no_head_width_the_jax_gate_refuses(interpret_kernels):
    """The port's K8 takes exactly the head widths the JAX gate admits at
    some image size: Dh 4, 8, 16, 32, 64, 128 and 256-896 by 128; never 1,
    2, 1024 or 1152, nor a width off those families."""
    admitted = {Dh for N in GATE_TOKENS for Dh in range(1, 1153) for H in GATE_HEADS
                if JF.flash_supported(2, N, H * Dh, H)}
    assert admitted == set(TF.HEAD_DIMS)
    assert {Dh for Dh in range(1, 1153) if any(TF.flash_supported(N, Dh)
                                               for N in GATE_TOKENS)} == admitted


@pytest.mark.parametrize("B_,m,D", [
    (16, 8, 49152),   # --image-size 128, batch 16 x m 8: both take the plain path
    (256, 8, 3072),   # the 32-px recipe: K3
    (64, 8, 49152), (8, 2, 49152), (8, 16, 3072), (8, 17, 3072), (5, 8, 3072),
    (4, 8, 3072), (1, 2, 128), (12, 4, 3072), (8, 8, 3000), (2, 8, 196608),
    (3, 1, 128), (16, 8, 12288),
])
def test_energy_gate_is_the_jax_kernel_gate(B_, m, D):
    assert TE.jax_kernel_gate(B_, m, D) == JE._kernel_supported(B_, m, D)


def test_dispatch_by_token_count():
    """Where the JAX ladder has a half-block tier (N <= 512 at these widths)
    the port takes K2's path; elsewhere the third rung around the core that
    JAX's ``fused_attention`` picks: K8 from N = 1024 (the port's K8 at
    every head width the JAX gate admits), the plain core between (N = 576,
    768), where JAX runs XLA's attention. The factory builds every size."""
    assert TF.flash_supported(1024, 64) and TF.flash_supported(16384, 64)
    assert TF.flash_supported(1024, 32) and TF.flash_supported(1024, 128)
    assert TF.flash_supported(1024, 16) and TF.flash_supported(1024, 896)
    assert not TF.flash_supported(512, 64) and not TF.flash_supported(1024, 24)
    assert not TF.flash_supported(1024, 2) and not TF.flash_supported(1024, 1024)
    assert not TF.flash_supported(1088 + 8, 64)
    r = np.random.default_rng(6)
    w = [torch.from_numpy(a.astype(np.float32)) for a in _attn_inputs(1, 256, 128, 6)[1:7]]
    w = [a.t().contiguous() if a.dim() == 2 else a for a in w]
    for N in (256, 512):
        x = torch.from_numpy(r.standard_normal((1, N, 128)).astype(np.float32))
        assert torch.equal(TA.fused_attention_block(x, *w, 2),
                           TA.attention_block_reference(x, *w, 2))
    for N in (576, 768):
        assert tiers.attention_tier(1, N, 128, 2) is None and tiers.core_tier(1, N, 128, 2) is None
        x = torch.from_numpy(r.standard_normal((1, N, 128)).astype(np.float32))
        assert torch.equal(TA.fused_attention_block(x, *w, 2),
                           TA.rung3_block_reference(x, *w, 2, None))
    assert build_model({"image_size": 64}, device="meta").num_patches == 256
    for size, n in ((96, 576), (112, 784), (128, 1024), (256, 4096), (512, 16384)):
        assert build_model({"image_size": size}, device="meta").num_patches == n
    assert tiers.core_tier(16, 1024, 256, 8) == "K8"  # Dh 32
    assert build_model({"image_size": 128, "embed_dim": 256, "heads": 8}, device="meta")
