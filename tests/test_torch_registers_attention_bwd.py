"""The registers designs of the two attention backwards, the core of K2b, K4
and K7b (``csrc/attention.cu`` with ``csrc/attention_bwd_regs.cuh``) and K8b
at Dh 32, 64 and 128 (``csrc/flash.cu``), on the CPU.

- The Python side: the ``design=`` names of the backward core and of K8b
  reach the library as its codes (a stand-in library records them), None
  passes -1, and an unknown name raises before any launch.
- The plain versions that the card holds the new kernels to
  (``tests/test_torch_cuda.py``, ``chip_smoke.py``) against the JAX kernels
  in Pallas interpret mode at the shapes the new designs stress: token
  counts that leave a ragged 64-key tile (16, 48, 80, 144, 272), head widths
  padded to a multiple of 16 (24, 72), with att (K2b's and K4's core: att is
  the forward core's output) and without (K7b); and K8's backward at Dh 32
  and 128.
- The dq side's two sweeps: each row's max m, sum l and u = sum e dP taken
  64 keys at a time in fp32, l and u rescaled as m grows, so that dsum = u /
  l; against JAX's rowsum(P dP) over the whole row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.flash as JF  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import flash as TF  # noqa: E402

# fp32: the two packages sum each row in another order (1e-4 relative, the
# absolute part scaled by the largest entry, as tests/test_torch_flash.py);
# bf16: two units in the last place at the largest output and a mean error
# far below one unit (the rule chip_smoke.py holds the kernels to)
F32_RTOL, F32_ATOL_OF_MAX = 1e-4, 1e-4


class _Library:
    """Stands in for the kernel library: records each entry point's
    arguments and reports success (a plan of zeros: the one-block design)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture()
def library(monkeypatch):
    lib = _Library()
    for module in (TA, TF):
        monkeypatch.setattr(module, "load_library", lambda: lib)
        monkeypatch.setattr(module, "current_stream", lambda device: 0)
    return lib


def _qkv(B, N, D):
    return torch.zeros(B, N, 3 * D, dtype=torch.bfloat16).split(D, dim=-1)


def _bwd_calls(library):
    return [args for name, args in library.calls if name == "ddm_attention_core_bwd"]


@pytest.mark.parametrize("design,code", [(None, -1), ("one-block", 0), ("two-pass", 1),
                                         ("streamed", 2), ("registers", 3),
                                         ("registers-fused", 4)])
def test_core_bwd_design_names_reach_the_library_as_its_codes(library, design, code):
    """Every entry to the backward core (K2b's and K4's core with att, K7b
    without, K2b's chain) passes ``ddm_attention_core_bwd`` the code of each
    name of BWD_DESIGNS (argument 13), and K7b counts its launch."""
    assert TA.BWD_DESIGNS.index("registers") == 3
    assert TA.BWD_DESIGNS.index("registers-fused") == 4
    B, N, H, Dh = 2, 48, 2, 72
    q, k, v = _qkv(B, N, H * Dh)
    do = torch.zeros(B, N, H * Dh, dtype=torch.bfloat16)
    att, dqkv = TA._launch_core_bwd(q, k, v, do, H, True, design)
    assert att.shape == (B, N, H * Dh) and dqkv.shape == (B, N, 3 * H * Dh)
    TA._core_bwd_att(torch.cat((q, k, v), dim=-1), do, H, design)
    before = TA.CORE_BWD_LAUNCHES.count
    TA.launch_k7b(q, k, v, do, H, design)
    assert TA.CORE_BWD_LAUNCHES.count == before + 1
    calls = _bwd_calls(library)
    assert len(calls) == 3 and all(a[13] == code for a in calls)
    assert calls[0][8:13] == (B, N, H, Dh, Dh ** -0.5)
    assert calls[0][5] is not None and calls[2][5] is None  # att only where asked


def test_k2b_chain_passes_its_design_to_the_core(library, monkeypatch):
    """``_k2b(design=)`` hands the name to the core it runs between the
    chain's GEMMs, and counts the launch on the tier's counter."""
    B, N, H, Dh = 2, 64, 6, 64
    qkv = torch.zeros(B, N, 3 * H * Dh, dtype=torch.bfloat16)
    datt = torch.zeros(B, N, H * Dh, dtype=torch.bfloat16)
    monkeypatch.setattr(TA, "_bwd_chain", lambda *args: args[-1](qkv, datt))
    before = TA.BWD_LAUNCHES.count
    TA._k2b(*([None] * 7), H, None, design="registers-fused")
    assert TA.BWD_LAUNCHES.count == before + 1
    (args,) = _bwd_calls(library)
    assert args[13] == 4


@pytest.mark.parametrize("design", ["register", "Registers", "fused", "tiles", ""])
def test_core_bwd_refuses_an_unknown_design_before_launching(library, design):
    q, k, v = _qkv(2, 64, 128)
    do = torch.zeros(2, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="design must be one of"):
        TA._launch_core_bwd(q, k, v, do, 2, True, design)
    with pytest.raises(ValueError, match="design must be one of"):
        TA.core_plan(64, 64, True, design)
    assert library.calls == []


@pytest.mark.parametrize("design,code", [(None, -1), ("tiles", 0), ("registers", 1)])
@pytest.mark.parametrize("Dh", TF.NARROW_DIMS + TF.REGISTERS_DIMS + TF.WIDE_DIMS)
def test_k8b_design_names_reach_the_library_as_its_codes(library, design, code, Dh):
    """``launch_k8b(design=)`` passes ``ddm_flash_bwd`` the code of each
    name of BWD_DESIGNS (argument 14), and counts the launch: at the narrow
    widths (the narrow registers design), at Dh 32-128 and at the wide
    widths, where "registers" is the wide registers design and "tiles" the
    chunked kernels."""
    assert TF.BWD_DESIGNS == ("tiles", "registers")
    H, N = max(1, 256 // Dh), 1024
    q, k, v = _qkv(1, N, H * Dh)
    o = do = torch.zeros(1, N, H * Dh, dtype=torch.bfloat16)
    lse = torch.zeros(1, H, N)
    before = TF.BWD_LAUNCHES.count
    dqkv = TF.launch_k8b(q, k, v, o, lse, do, H, Dh ** -0.5, design)
    (name, args), = library.calls
    assert name == "ddm_flash_bwd" and args[14] == code
    assert args[9:13] == (1, N, H, Dh)
    assert dqkv.shape == (1, N, 3 * H * Dh)
    assert TF.BWD_LAUNCHES.count == before + 1


@pytest.mark.parametrize("design", ["register", "wgmma", "one-block"])
def test_k8b_refuses_an_unknown_design_before_launching(library, design):
    q, k, v = _qkv(1, 1024, 128)
    lse = torch.zeros(1, 2, 1024)
    before = TF.BWD_LAUNCHES.count
    with pytest.raises(ValueError, match="design must be one of"):
        TF.launch_k8b(q, k, v, q, lse, q, 2, 64 ** -0.5, design)
    assert library.calls == [] and TF.BWD_LAUNCHES.count == before


@pytest.mark.parametrize("design", ["register", "narrow", "one-block"])
@pytest.mark.parametrize("Dh", TF.NARROW_DIMS)
def test_k8b_refuses_an_unknown_design_at_the_narrow_widths(library, design, Dh):
    """An unknown name raises before any launch at Dh 4, 8 and 16 as at the
    other widths."""
    H = 384 // Dh
    q, k, v = _qkv(1, 1024, H * Dh)
    lse = torch.zeros(1, H, 1024)
    before = TF.BWD_LAUNCHES.count
    with pytest.raises(ValueError, match="design must be one of"):
        TF.launch_k8b(q, k, v, q, lse, q, H, Dh ** -0.5, design)
    assert library.calls == [] and TF.BWD_LAUNCHES.count == before


def _close(got, want, dtype, name):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                   atol=F32_ATOL_OF_MAX * float(np.abs(want).max()),
                                   err_msg=name)
        return
    top = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7), name
    assert err.mean() <= 1e-3, name


# (B, N, H, Dh): ragged last key and query tiles (N % 64 = 16, 48, 16, 16),
# one whole tile (64: the fused block on the card), padded heads (24 -> 32,
# 72 -> 80) and a whole one (64)
CORE_SHAPES = [(2, 16, 4, 24), (2, 48, 2, 72), (2, 64, 2, 24), (2, 80, 2, 64),
               (1, 144, 4, 24), (1, 272, 2, 24), (1, 272, 1, 72)]


@pytest.mark.parametrize("att", [True, False])
@pytest.mark.parametrize("B,N,H,Dh", CORE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_core_bwd_matches_jax_at_ragged_tiles_and_padded_heads(monkeypatch, dtype, B, N,
                                                                     H, Dh, att):
    """The backward core's plain versions (on CPU tensors: K2b's and K4's
    ``attention_core_bwd_att_reference``, K7b's ``attention_core_bwd``), the
    oracles of the card's registers designs, against JAX's K7 backward
    (``_fused_bwd`` -> ``_bwd_kernel``, the core K2b's and K4's bodies run)
    and, for att, its forward (``_fused_fwd_call``), in interpret mode."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    assert TA.supported_tokens(N, Dh)
    r = np.random.default_rng(7 * N + Dh)
    q, k, v, do = (r.standard_normal((B, N, H * Dh)).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v, do))
    scale = Dh ** -0.5
    want = [np.asarray(g, np.float32) for g in JA._fused_bwd(H, scale, (jq, jk, jv), jdo)]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, do))
    before = TA.CORE_BWD_LAUNCHES.count
    if att:
        want.insert(0, np.asarray(JA._fused_fwd_call(jq, jk, jv, H, scale), np.float32))
        got = TA.attention_core_bwd_att_reference(tq, tk, tv, tdo, H)
        labels = ("att", "dq", "dk", "dv")
    else:
        got = TA.attention_core_bwd(tq, tk, tv, tdo, H)
        labels = ("dq", "dk", "dv")
    assert TA.CORE_BWD_LAUNCHES.count == before  # CPU: the plain version
    for label, g, w in zip(labels, got, want):
        _close(g.float().numpy(), w, dtype, f"{label} {dtype} (B={B}, N={N}, H={H}, Dh={Dh})")


@pytest.mark.parametrize("Dh,H", [(32, 4), (128, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k8b_matches_jax_at_dh_32_and_128(monkeypatch, dtype, Dh, H):
    """K8b's plain version (dq, dk, dv from o and lse, dsum from the rounded
    o) against JAX's flash backward in interpret mode, both on JAX's forward
    outputs, at N = 1024 and the registers design's two widths other than
    tests/test_torch_flash.py's Dh 64."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    N, D = 1024, H * Dh
    assert JF.flash_supported(1, N, D, H) and TF.flash_supported(N, Dh)
    r = np.random.default_rng(Dh + 1)
    q, k, v, do = (r.standard_normal((1, N, D)).astype(np.float32) for _ in range(4))
    scale = Dh ** -0.5
    o, res = JF._flash_fwd(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), H, scale)
    want = [np.asarray(g, np.float32)
            for g in JF._flash_bwd(H, scale, res, jnp.asarray(do, getattr(jnp, dtype)))]
    hp = JF._heads_per_group(Dh)  # lse is (B * H / hp, N, hp)
    lse = np.asarray(res[4]).reshape(1, H // hp, N, hp).transpose(0, 1, 3, 2).reshape(1, H, N)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))  # noqa: E731
    before = TF.BWD_LAUNCHES.count
    got = TF.flash_attention_bwd(t(q), t(k), t(v), t(o), torch.tensor(lse), t(do), H)
    assert TF.BWD_LAUNCHES.count == before
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.float().numpy(), w, dtype, f"K8b {label} {dtype} Dh {Dh}")


def _two_sweeps(s, dp, keys=64):
    """The dq side's first sweep in plain torch, fp32: over ``keys``-key
    tiles of the scaled scores s and of dP, each row's running max m, its
    sum l of e = exp(s - m) and u = sum e dP, l and u rescaled by exp(m_old
    - m_new) as m grows: ``(m, l, u / l)``."""
    rows = s.shape[0]
    m = torch.full((rows,), -float("inf"))
    l, u = torch.zeros(rows), torch.zeros(rows)
    for k0 in range(0, s.shape[1], keys):
        st, dpt = s[:, k0:k0 + keys], dp[:, k0:k0 + keys]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        e = torch.exp(st - m_new[:, None])
        l = l * corr + e.sum(-1)
        u = u * corr + (e * dpt).sum(-1)
        m = m_new
    return m, l, u / l


@pytest.mark.parametrize("N", [144, 272])
def test_two_sweep_dsum_matches_jax_rowsum_of_p_dp(N):
    """dsum = u / l from the first sweep's 64-key tiles is JAX's rowsum(P
    dP) with the fp32 P over the whole row (``_bwd_kernel``'s
    ``jnp.sum(probs * dp, -1)``), and m and l its max and sum, to fp32."""
    r = np.random.default_rng(N)
    Dh = 64
    q, k, v, do = (r.standard_normal((N, Dh)).astype(np.float32) for _ in range(4))
    s = (q @ k.T) * Dh ** -0.5
    dp = do @ v.T
    with jax.default_device(jax.devices("cpu")[0]):
        js = jnp.asarray(s)
        probs = jax.nn.softmax(js, axis=-1)
        want_dsum = np.asarray(jnp.sum(probs * jnp.asarray(dp), axis=-1))
        want_m = np.asarray(jnp.max(js, axis=-1))
        want_l = np.asarray(jnp.sum(jnp.exp(js - want_m[:, None]), axis=-1))
    m, l, dsum = _two_sweeps(torch.from_numpy(s), torch.from_numpy(dp))
    np.testing.assert_array_equal(m.numpy(), want_m)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=F32_RTOL)
    np.testing.assert_allclose(dsum.numpy(), want_dsum, rtol=F32_RTOL,
                               atol=F32_ATOL_OF_MAX * float(np.abs(want_dsum).max()))
