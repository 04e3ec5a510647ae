"""Parity of the port's MoE dispatch and combine (the plain versions of K11
and K12, through their ``torch.autograd.Function``s) with the JAX
package's Pallas kernels ``moe_dispatch``, ``moe_dispatch_thru``,
``moe_combine`` and ``moe_combine_res``, run in interpret mode.

Shapes: T = 128 rows of D = 128 (the JAX kernels need D % 128 == 0), E = 4
experts, routing groups of 32. Capacity 1.25 gives cap 10 (Cp = 16 slot
rows, so padded slots) at top-1 and cap 20 (Cp = 24) at top-2; capacity
0.4 (cap 4 and 7, Cp = 8) drops tokens. The wide cases take two groups of
64 rows at DiT-XL/4's D = 1152 with 8 experts (top-1 and top-2) and 16
(top-2), and 48 experts at D = 256 (top-2: more experts than a warp has
lanes). Past the port's earlier bounds (E 64, D 4096), four groups of 64
rows take 128 experts (top-1 and top-2) and 256 (top-2) at D = 128, and 8
experts (top-2) at D = 4224 and at Mixtral-8x22B's D = 6144. Routing must
agree exactly: both sides are plain fp32
arithmetic here, and the inputs keep every token's two largest router
probabilities well apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.moe_dispatch as JD  # noqa: E402
from ddm_tpu_torch.ops import moe_dispatch as TD  # noqa: E402
from ddm_tpu_torch.ops.mlp_block import layer_norm  # noqa: E402

T = 128
# name: (topk, capacity, D, E, group size[, rows: T when not given])
CASES = {"top1": (1, 1.25, 128, 4, 32), "top2": (2, 1.25, 128, 4, 32),
         "top1-drops": (1, 0.4, 128, 4, 32), "top2-drops": (2, 0.4, 128, 4, 32),
         "xl-e8-top1": (1, 1.25, 1152, 8, 64), "xl-e8-top2": (2, 1.25, 1152, 8, 64),
         "xl-e16-top2": (2, 1.25, 1152, 16, 64), "e48-top2": (2, 1.25, 256, 48, 64),
         "e128-top1": (1, 1.25, 128, 128, 64, 256), "e128-top2": (2, 1.25, 128, 128, 64, 256),
         "e256-top2": (2, 1.25, 128, 256, 64, 256), "d4224-top2": (2, 1.25, 4224, 8, 64, 256),
         "d6144-top2": (2, 1.25, 6144, 8, 64, 256)}


def _rows(case) -> int:
    return CASES[case][5] if len(CASES[case]) > 5 else T


def _bf16_spacing(want):
    """Elementwise: one bf16 unit in the last place at each entry of ``want``."""
    a = np.abs(np.asarray(want, np.float32))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.maximum(a, 1e-30))) - 7), 0.0)


def _bf16_ulp(want) -> float:
    """One bf16 unit in the last place at the largest magnitude of ``want``."""
    return float(_bf16_spacing(np.abs(np.asarray(want, np.float32)).max()))


def _wide(a) -> bool:
    """The cases past D = 128. There a yb = bf16(LN(x)) entry whose fp32
    value lies next to a rounding boundary can round to its other neighbour,
    since the LN statistics' fp32 sums run in another order in XLA than in
    PyTorch; among the 128 x 1152 entries a few do (one unit), or one near
    zero moves by a few fp32 units of the terms it cancels. So xin is held
    to one bf16 unit at its largest entry with a mean far below it (dx's
    rule), and the fp32 gradients summed over the rows to the card tests'
    rule for sums behind a flipped bf16 rounding: 1e-2 of the largest entry,
    1e-3 relative Frobenius."""
    return a["x"].shape[1] > 128


def _cfgs(case):
    topk, capacity, _, E, gs = CASES[case][:5]
    cfg, T_pad = TD.moe_cfg(_rows(case), E, gs, capacity, topk)
    assert T_pad == _rows(case) and cfg.gs == gs and cfg.cpad % 8 == 0
    jcfg = JD.MoEDispatchCfg(gs=cfg.gs, cap=cfg.cap, cpad=cfg.cpad, num_experts=E, topk=topk,
                             cdt="bfloat16")
    return cfg, jcfg


def _inputs(cfg, D, T=T, seed=0):
    r = np.random.default_rng(seed)
    G, E = T // cfg.gs, cfg.num_experts
    return dict(
        x=r.standard_normal((T, D)).astype(np.float32),
        scale=(1 + 0.1 * r.standard_normal(D)).astype(np.float32),
        bias=(0.1 * r.standard_normal(D)).astype(np.float32),
        wr=(D ** -0.5 * r.standard_normal((D, E))).astype(np.float32),
        br=(0.1 * r.standard_normal(E)).astype(np.float32),
        dxin=r.standard_normal((E, G * cfg.cpad, D)).astype(np.float32),
        dgates=r.standard_normal((G, cfg.gs, 2)).astype(np.float32),
        dpsum=r.standard_normal(E).astype(np.float32),
        dres=r.standard_normal((T, D)).astype(np.float32),
        eout=r.standard_normal((E, G * cfg.cpad, D)).astype(np.float32),
        dpart=r.standard_normal((T, D)).astype(np.float32),
    )


def _jax(a, *keys):
    return tuple(jnp.asarray(a[k], jnp.bfloat16 if k in ("x", "dxin", "dres", "eout", "dpart")
                             else jnp.float32) for k in keys)


def _torch(a, *keys):
    return tuple(torch.from_numpy(a[k]).to(torch.bfloat16 if k in ("x", "dxin", "dres", "eout",
                                                                   "dpart") else torch.float32)
                 for k in keys)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One routing case: the JAX kernels' forward outputs and cotangents."""
    cfg, jcfg = _cfgs(request.param)
    E = cfg.num_experts
    a = _inputs(cfg, CASES[request.param][2], _rows(request.param))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
        fwd = [np.asarray(o, np.float32) for o in JD._dispatch_fwd_call(
            jcfg, *_jax(a, "x", "scale", "bias", "wr", "br"))]
        xin, gates, pos1, pos2 = (jnp.asarray(v) for v in fwd[:4])

        def dispatch(thru):
            fn = JD.moe_dispatch_thru if thru else JD.moe_dispatch
            outs, vjp = jax.vjp(lambda *w: fn(jcfg, *w), *_jax(a, "x", "scale", "bias", "wr",
                                                                "br"))
            cts = [jnp.asarray(a["dxin"], jnp.bfloat16), jnp.asarray(a["dgates"]),
                   jnp.zeros_like(outs[2]), jnp.zeros_like(outs[3]), jnp.zeros_like(outs[4]),
                   jnp.asarray(a["dpsum"]).reshape(1, E)]
            if thru:
                cts.append(jnp.asarray(a["dres"], jnp.bfloat16))
            return [np.asarray(g, np.float32) for g in vjp(tuple(cts))]

        def combine(res):
            eout = jnp.asarray(a["eout"], jnp.bfloat16)
            args = (eout, gates, pos1, pos2) + ((jnp.asarray(a["dres"], jnp.bfloat16),)
                                                 if res else ())
            fn = JD.moe_combine_res if res else JD.moe_combine
            part, vjp = jax.vjp(lambda *w: fn(jcfg, *w), *args)
            grads = vjp(jnp.asarray(a["dpart"], jnp.bfloat16))
            return np.asarray(part, np.float32), [np.asarray(g, np.float32) for g in grads]

        ref = {"fwd": fwd, "bwd": dispatch(False), "bwd_thru": dispatch(True),
               "combine": combine(False), "combine_res": combine(True)}
    return request.param, cfg, a, ref


def test_dispatch_forward_matches_jax(case):
    name, cfg, a, ref = case
    E = cfg.num_experts
    xin, gates, pos1, pos2, probs, cnt, psum = ref["fwd"]
    got = TD.moe_dispatch_fwd(cfg, *_torch(a, "x", "scale", "bias", "wr", "br"))
    g_xin, g_gates, g_pos1, g_pos2, g_probs, g_cnt, g_psum = (_np(t) for t in got)
    np.testing.assert_array_equal(g_pos1, pos1)
    np.testing.assert_array_equal(g_pos2, pos2)
    np.testing.assert_array_equal(g_cnt, cnt.reshape(E))
    assert got[0].dtype == torch.bfloat16 and g_xin.shape == xin.shape
    if _wide(a):
        assert np.abs(g_xin - xin).max() <= _bf16_ulp(xin) and np.abs(g_xin - xin).mean() <= 1e-3
    else:
        assert (np.abs(g_xin - xin) <= _bf16_spacing(xin)).all()
    # the wide cases: a flipped yb unit (see _wide) moves a logit by up to one
    # bf16 unit of max |yb| times max |wr|; the router's outputs within twice that
    yb = layer_norm(torch.from_numpy(a["x"]).to(torch.bfloat16).float(),
                    *_torch(a, "scale", "bias")).to(torch.bfloat16)
    atol = 2 * _bf16_ulp(_np(yb)) * np.abs(a["wr"]).max() if _wide(a) else 1e-7
    for g, w in ((g_gates, gates), (g_probs, probs), (g_psum, psum.reshape(E))):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol)
    # the case does what its name says: padded slots, and drops where named
    assert cfg.cpad > cfg.cap
    if name.endswith("drops"):
        assert pos1.max() >= cfg.cap or pos2.max() >= cfg.cap
    assert (pos2 >= 0).any() == (cfg.topk == 2)
    # every slot row no token holds is zero
    held = sum(_kept(pos, cfg.cap) for pos in (g_pos1, g_pos2))
    assert held == int((np.abs(g_xin).sum(-1) > 0).sum())


def _kept(pos, cap) -> int:
    e, p = TD.chosen(torch.from_numpy(pos))
    return int(((e >= 0) & (p < cap)).sum())


def _close_grads(got, want, label, wide=False):
    """dx (bf16): one bf16 unit at the largest entry; the fp32 parameter
    gradients: 1e-4 relative (sums over T rows in another order), or in
    the wide cases :func:`_wide`'s rule."""
    names = ["dx", "dscale", "dbias", "dwr", "dbr"]
    for n, g, w in zip(names, got, want):
        g = _np(g).reshape(w.shape)
        if n == "dx":
            assert np.abs(g - w).max() <= _bf16_ulp(w), (label, n)
            assert np.abs(g - w).mean() <= 1e-3, (label, n)
        elif wide:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), (label, n)
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), (label, n)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{label} {n}")


@pytest.mark.parametrize("thru", [False, True], ids=["dispatch", "dispatch_thru"])
def test_dispatch_backward_matches_jax(case, thru):
    name, cfg, a, ref = case
    want = ref["bwd_thru" if thru else "bwd"]
    x, scale, bias, wr, br = _torch(a, "x", "scale", "bias", "wr", "br")
    dxin, dres = _torch(a, "dxin", "dres")
    dgates, dpsum = torch.from_numpy(a["dgates"]), torch.from_numpy(a["dpsum"])
    # explicit: the plain backward on the forward's routing state
    _, _, pos1, pos2, probs, _, _ = TD.moe_dispatch_fwd(cfg, x, scale, bias, wr, br)
    got = TD.moe_dispatch_bwd(cfg, x, scale, bias, wr, pos1, pos2, probs, dxin, dgates, dpsum,
                              dres if thru else None)
    _close_grads(got, want, f"{name} explicit", _wide(a))
    # through the autograd Function, the pass-through's cotangent included
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias, wr, br)]
    fn = TD.moe_dispatch_thru if thru else TD.moe_dispatch
    outs = fn(cfg, *leaves)
    assert not outs[2].requires_grad and not outs[4].requires_grad  # pos1, cnt
    terms = [(outs[0].float() * dxin.float()).sum(), (outs[1] * dgates).sum(),
             (outs[5] * dpsum).sum()]
    if thru:
        assert outs[6].data_ptr() == leaves[0].data_ptr()  # x itself
        terms.append((outs[6].float() * dres.float()).sum())
    sum(terms).backward()
    _close_grads([t.grad for t in leaves], want, f"{name} autograd", _wide(a))


@pytest.mark.parametrize("res", [False, True], ids=["combine", "combine_res"])
def test_combine_forward_and_backward_match_jax(case, res):
    name, cfg, a, ref = case
    want_part, want_grads = ref["combine_res" if res else "combine"]
    G, D = a["x"].shape[0] // cfg.gs, a["x"].shape[1]
    fwd = ref["fwd"]
    gates, pos1, pos2 = (torch.from_numpy(fwd[i].copy()) for i in (1, 2, 3))
    eout, dres, dpart = _torch(a, "eout", "dres", "dpart")
    leaves = [eout.clone().requires_grad_(), gates.clone().requires_grad_()]
    extra = [dres.clone().requires_grad_()] if res else []
    fn = TD.moe_combine_res if res else TD.moe_combine
    part = fn(cfg, leaves[0], leaves[1], pos1, pos2, *extra)
    assert part.dtype == torch.bfloat16 and part.shape == (G * cfg.gs, D)
    # each output's combine is an fp32 sum of two gated rows, which JAX's
    # kernel takes as a one-hot product in expert order and the plain
    # version as two rounded terms: the sums differ by up to delta, an fp32
    # rounding of each term. Where the combine's bf16 rounding can go either
    # way within delta, the bound adds delta and one bf16 unit of the
    # combine: it nearly cancels (one bf16 unit of the sum is below delta),
    # or with the residual, which joins after that rounding, the output is
    # smaller than the combine. Elsewhere it is one bf16 unit of the output
    mag = _np(TD.moe_combine_reference(cfg, eout.abs(), gates.abs(), pos1, pos2))
    comb = TD.moe_combine_reference(cfg, eout.float(), gates, pos1, pos2)
    delta = torch.from_numpy(2.0 ** -23 * mag)
    either = ((comb - delta).to(torch.bfloat16) != (comb + delta).to(torch.bfloat16)).numpy()
    slack = _np(delta) + _bf16_spacing(np.abs(_np(comb)) + _np(delta))
    tol = _bf16_spacing(want_part) + np.where(either, slack, 0.0)
    assert (np.abs(_np(part.detach()) - want_part) <= tol).all(), name
    part.backward(dpart)
    dout, dgates = leaves[0].grad, leaves[1].grad
    want_dout, want_dgates = want_grads[0], want_grads[1]
    assert (np.abs(_np(dout) - want_dout) <= _bf16_spacing(want_dout)).all(), name
    np.testing.assert_allclose(_np(dgates), want_dgates, rtol=1e-5,
                               atol=1e-6 * np.abs(want_dgates).max(), err_msg=name)
    if res:  # the residual's cotangent is the output's
        np.testing.assert_array_equal(_np(extra[0].grad), want_grads[4])
        np.testing.assert_array_equal(_np(extra[0].grad), _np(dpart))
    # every slot row no token holds gets a zero cotangent
    held = np.abs(_np(TD.moe_dispatch_fwd(cfg, *_torch(a, "x", "scale", "bias", "wr", "br"))[0]
                      ).sum(-1)) > 0
    assert not _np(dout)[~held].any()


def test_geometry_and_shape_gate():
    cfg, T_pad = TD.moe_cfg(131072, 8, 256, 1.25, 1)
    assert (cfg.gs, cfg.cap, cfg.cpad, T_pad) == (256, 40, 40, 131072)
    cfg2, _ = TD.moe_cfg(131072, 8, 256, 1.25, 2)
    assert (cfg2.cap, cfg2.cpad) == (80, 80)
    cfg3, T_pad3 = TD.moe_cfg(384, 8, 256, 1.25, 1)  # --n 6 at 32 px: one padded group
    assert (cfg3.gs, T_pad3) == (256, 512)
    cfg4, T_pad4 = TD.moe_cfg(100, 4, 256, 1.25, 1)  # fewer rows than one group
    assert (cfg4.gs, cfg4.cap, T_pad4) == (100, 32, 100)
    for good in ((256, 8, 40, 384, 1), (256, 8, 40, 1152, 2), (256, 16, 40, 1024, 1),
                 (256, 64, 40, 384, 1), (2048, 64, 40, 4096, 2), (8, 2, 1, 128, 1),
                 (256, 65, 40, 384, 1), (256, 8, 40, 4224, 1)):
        assert TD.moe_dispatch_ok(*good), good
    for bad in ((256, 8, 40, 384, 3), (4096, 8, 40, 384, 1), (100, 8, 40, 384, 1),
                (256, 1, 40, 384, 1), (256, 8, 40, 96, 1),
                (256, 8, 40, 192, 1), (256, 8, 0, 384, 1)):
        assert not TD.moe_dispatch_ok(*bad), bad
    # K11b's per-group partials: one slab of all D columns on the shipped
    # shapes (DiT-S/4 at 128 experts: 102 MB), column slabs within the
    # scratch bound where G x D x E grows past it
    assert TD._bwd_slab(512, 384, 128) == 384 and TD._bwd_slab(512, 6144, 8) == 6144
    G, D, E = 512, 8192, 512
    slab = TD._bwd_slab(G, D, E)
    assert slab % 128 == 0 and 128 <= slab < D
    assert G * (2 * slab + slab * E + E) * 4 <= TD.MOE_BWD_SCRATCH_BYTES
    assert G * (2 * (slab + 128) + (slab + 128) * E + E) * 4 > TD.MOE_BWD_SCRATCH_BYTES


def test_shape_gate_against_jax(monkeypatch):
    """The port's gate is the JAX gate on every swept shape: it bounds
    neither D nor E, so no shape the JAX gate takes is refused, and
    ``ops/moe_dispatch.py`` has no refusal left to raise."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")  # the JAX gate off the TPU
    refused = taken = 0
    for gs in (8, 64, 100, 256, 2048, 4096):
        for E in (1, 2, 8, 33, 48, 64, 65, 128, 256, 512):
            for D in (64, 128, 192, 384, 1152, 2048, 4096, 4224, 6144, 8192):
                for cap, topk in ((0, 1), (40, 1), (40, 2), (40, 3)):
                    ours = TD.moe_dispatch_ok(gs, E, cap, D, topk)
                    theirs = JD.moe_dispatch_ok(2 * gs, gs, E, cap, D, topk)
                    assert ours == theirs, (gs, E, cap, D, topk)
                    refused += theirs and not ours
                    taken += ours and (D > 4096 or E > 64)
    assert refused == 0 and taken > 0
    assert not hasattr(TD, "_refuse_unported")
    with pytest.raises(ValueError, match="topk"):
        TD.moe_cfg(128, 4, 32, 1.25, 3)
