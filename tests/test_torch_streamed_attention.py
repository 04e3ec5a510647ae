"""The attention cores at every shape the JAX gates send to K2f, K2b, K4 and
K7, past the shapes whose whole head fits the card's shared memory: the
port's checks against the gates over the image sizes and widths a DiT
takes, and the port's plain versions (the oracle the streamed CUDA cores
are held to on the card, ``tests/test_torch_cuda.py``) against the JAX
kernels in Pallas interpret mode at DiT-S/4 ``--heads 1`` at 64 px (the
fused tier), DiT-B/4 ``--heads 1`` (the split tier) and a K7 shape past D
1344.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import tiers  # noqa: E402

# the sweep: N of 16, 32 px at patch 8 or 4 (16, 64), 48, 64 and 80 px at
# patch 4 (144, 256, 400); D up to 8192 by 64; H up to 128; the batches a
# step or the sampler gives the half-block (images x m)
SWEEP_N = (16, 64, 144, 256, 400)
SWEEP_B = (8, 16, 64, 256, 2048)
NAMES = ["out", "x", "scale", "bias", "wqkv", "bqkv", "wproj", "bproj"]
# fp32: sums of B*N rows taken in another order, 1e-4 relative with the
# absolute part scaled by each tensor's largest entry; bf16: both sides
# round at the same points, but a flipped rounding of one bf16 intermediate
# (qkv, P, dS, datt) moves single entries by a bf16 unit (the tolerances of
# tests/test_torch_split_attention.py)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=3.2e-2)


def _kernel_shapes():
    """Every (B, N, D, H) of the sweep that a JAX gate sends to a core: the
    half-block tiers (K2f with K2b or K4) and K7."""
    for N in SWEEP_N:
        for D in range(64, 8193, 64):
            for H in range(1, 129):
                if D % H:
                    continue
                for B in SWEEP_B:
                    tier = tiers.attention_tier(B, N, D, H)
                    if tier is not None or tiers.core_tier(B, N, D, H) == "K7":
                        yield B, N, D, H, tier


class Launched(Exception):
    pass


def _launch(*a):
    raise Launched


def _meta(B, N, D):
    x = torch.empty((B, N, D), dtype=torch.bfloat16, device="meta")
    w = [torch.empty(s, device="meta") for s in ((D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,))]
    return x, w


def test_port_takes_every_shape_the_jax_gates_send_to_the_cores(monkeypatch):
    """Over the sweep, every shape a JAX gate sends to K2f/K2b/K4 or K7 passes
    the port's checks and reaches its first launch on the card: the
    half-block's forward and backward, and the third rung's forward around
    K7 (which checks the core both ways before any launch). Meta tensors:
    only shapes are read. The refusal that named the cores past 227 KB is
    gone from the package."""
    monkeypatch.setattr(TA, "uses_kernel", lambda *t: True)
    for name in ("_fwd_chain", "_bwd_chain", "launch_k7f"):
        monkeypatch.setattr(TA, name, _launch)
    seen, widths = set(), {}
    shapes = list(_kernel_shapes())
    # the three paths (DiT-S/4 --heads 1 at 64 px, DiT-B/4 --heads 1, DiT-L/4
    # --heads 2 at 64 px) and the widest heads are among them
    for want in ((256, 384, 1, "fused"), (64, 768, 1, "split"), (256, 1024, 2, None),
                 (16, 3712, 1, None), (144, 3328, 1, None), (256, 1792, 1, None),
                 (400, 1024, 1, None)):
        assert want in {(N, D, H, tier) for _, N, D, H, tier in shapes}, want
    for B, N, D, H, tier in shapes:
        Dh = D // H
        assert TA.supported_tokens(N, Dh), (B, N, D, H)
        widths[N] = max(widths.get(N, 0), Dh)
        if (N, D, H, tier) in seen:
            continue
        seen.add((N, D, H, tier))
        x, w = _meta(B, N, D)
        with pytest.raises(Launched):
            TA.fused_attention_block(x, *w, H)
        if tier is not None:
            with pytest.raises(Launched):
                TA.attention_block_bwd(x, *w, H, torch.empty_like(x))
    # the widest heads the gates send per N (the table in ROADMAP.md Queue 2)
    assert widths == {16: 3712, 64: 1792, 144: 3328, 256: 1792, 400: 1024}
    package = Path(TA.__file__).resolve().parents[1]
    for path in list(package.rglob("*.py")) + list(package.rglob("*.cu")):
        assert "cores past 227 KB" not in path.read_text(), path


def _block_inputs(B, N, D, seed):
    r = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        r.standard_normal((B, N, D)), 1 + 0.1 * r.standard_normal(D), 0.1 * r.standard_normal(D),
        D ** -0.5 * r.standard_normal((D, 3 * D)), 0.1 * r.standard_normal(3 * D),
        D ** -0.5 * r.standard_normal((D, D)), 0.1 * r.standard_normal(D),
        r.standard_normal((B, N, D)))]


def _close(got, want, tol, name):
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.mark.parametrize("B,N,D,H,tier", [(2, 256, 384, 1, "fused"), (2, 64, 768, 1, "split")],
                         ids=["dit-s-h1-64px", "dit-b-h1"])
def test_half_block_matches_jax_at_one_head(monkeypatch, B, N, D, H, tier):
    """JAX's ``fused_attention_block`` (K2f with K2b, or with K4, in Pallas
    interpret mode) against the port's half-block on the same numpy inputs:
    the output and all seven gradients, fp32 and bf16. On CPU tensors the
    port runs the plain versions that the streamed cores match on the card."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    g = JA._attn_pack(B, N, D, H)
    assert g >= 1 and tiers.attention_tier(B, N, D, H) == tier
    fused = JA._bwd_block_images(B, N, D, g, H) >= g
    assert fused == (tier == "fused")
    assert fused or JA._bwd_split_block_images(B, N, D, g, H) >= g
    *args, dout = _block_inputs(B, N, D, seed=N + D)
    for name, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        jd, td = getattr(jnp, name), getattr(torch, name)
        out, vjp = jax.vjp(lambda *a: JA.fused_attention_block(*a, H),
                           jnp.asarray(args[0], jd), *(jnp.asarray(a) for a in args[1:]))
        want = [np.asarray(out, np.float32)] + [np.asarray(v, np.float32)
                                                for v in vjp(jnp.asarray(dout, jd))]
        # nn.Linear's (out, in) layout: JAX's (in, out) transposed
        leaves = [torch.from_numpy(args[0]).to(td)] + [
            torch.from_numpy(a).t().contiguous() if a.ndim == 2 else torch.from_numpy(a)
            for a in args[1:]]
        leaves = [a.detach().requires_grad_() for a in leaves]
        got_out = TA.fused_attention_block(*leaves, H)
        got_out.backward(torch.from_numpy(dout).to(td))
        got = [got_out.detach().float().numpy()] + [
            (a.grad.t() if a.grad.dim() == 2 and i else a.grad).float().numpy()
            for i, a in enumerate(leaves)]
        for n, gv, wv in zip(NAMES, got, want):
            _close(gv, wv, tol, f"{name} {n}")


def test_k7_matches_jax_past_the_half_block_widths(monkeypatch):
    """JAX's ``fused_attention`` (K7, ``_fused_attention`` in interpret mode)
    against the port's ``fused_attention`` at N 64, D 1536 over 2 heads (Dh
    768: pass 1's whole-head tile passes the card's 227 KB, so the card
    streams it): o, dq, dk and dv, fp32 and bf16."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    B, N, D, H = 2, 64, 1536, 2
    g = JA._choose_blocks(B, N, D)[1]
    assert B % JA._choose_blocks(B, N, D)[0] == 0 and D % 128 == 0
    assert JA._core_bwd_block_images(B, N, D, g) >= max(g, 1)  # JAX's K7 takes it
    assert tiers.core_tier(B, N, D, H) == "K7"
    r = np.random.default_rng(7)
    q, k, v, do = (r.standard_normal((B, N, D)).astype(np.float32) for _ in range(4))
    for name, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        jd, td = getattr(jnp, name), getattr(torch, name)
        out, vjp = jax.vjp(lambda a, b, c: JA.fused_attention(a, b, c, H),
                           *(jnp.asarray(a, jd) for a in (q, k, v)))
        want = [np.asarray(out, np.float32)] + [np.asarray(t, np.float32)
                                                for t in vjp(jnp.asarray(do, jd))]
        leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in (q, k, v)]
        o = TA.fused_attention(*leaves, H)
        grads = torch.autograd.grad(o, leaves, torch.from_numpy(do).to(td))
        for n, gv, wv in zip(("o", "dq", "dk", "dv"), (o.detach(), *grads), want):
            _close(gv.float().numpy(), wv, tol, f"{name} {n}")
