"""The wide registers designs of the two attention backwards on the CPU: K8b
at Dh 256-896 (``csrc/flash.cu``'s wide dq side) and the backward core of
K2b, K4 and K7b past a padded head of 128 (``csrc/attention.cu``'s wide dq
side), both with the dk/dv side of ``csrc/attention_bwd_regs.cuh``.

- The Python side: every backward core design name at padded widths
  144-896 reaches the library as its code (a stand-in library records
  them), None passes -1, and an unknown name raises before any launch
  (K8b's names at its wide widths: tests/test_torch_registers_attention_bwd.py).
- The plain versions that the card holds the new kernels to
  (``tests/test_torch_cuda.py``, ``chip_smoke.py`` 3z) against the JAX
  kernels in Pallas interpret mode: K8b's at Dh 512 and 896 (one image, one
  or two heads; ``tests/test_torch_flash.py`` covers Dh 256 and 384), the
  backward core's at padded widths 136 (144), 256 and 384 at ragged N 48,
  80 and 272, with att (K2b's and K4's core: att is the forward core's
  output) and without (K7b).
"""

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
    arguments and reports success."""

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


@pytest.mark.parametrize("design", [None, *TA.BWD_DESIGNS])
@pytest.mark.parametrize("Dh", [136, 256, 392, 512, 648, 768, 896])
def test_core_bwd_design_names_reach_the_library_past_128(library, design, Dh):
    """Past a padded head of 128 (Dh 136 -> 144, 392 -> 400, 648 -> 656)
    every entry to the backward core passes ``ddm_attention_core_bwd`` the
    code of each name of BWD_DESIGNS (argument 13, -1 for None) with stats
    scratch (every design but the one-block one), and K7b counts its launch."""
    B, N, H = 2, 80, 1
    q, k, v = _qkv(B, N, H * Dh)
    do = torch.zeros(B, N, H * Dh, dtype=torch.bfloat16)
    code = -1 if design is None else TA.BWD_DESIGNS.index(design)
    att, dqkv = TA._launch_core_bwd(q, k, v, do, H, True, design)
    assert att.shape == (B, N, H * Dh) and dqkv.shape == (B, N, 3 * H * Dh)
    before = TA.CORE_BWD_LAUNCHES.count
    TA.launch_k7b(q, k, v, do, H, design)
    assert TA.CORE_BWD_LAUNCHES.count == before + 1
    calls = [args for name, args in library.calls if name == "ddm_attention_core_bwd"]
    assert len(calls) == 2 and all(a[13] == code for a in calls)
    assert calls[0][8:13] == (B, N, H, Dh, Dh ** -0.5)
    assert calls[0][5] is not None and calls[1][5] is None  # att only where asked


@pytest.mark.parametrize("design", ["wide", "registers-wide", "tiles", "register", ""])
def test_core_bwd_wide_refuses_an_unknown_design_before_launching(library, design):
    q, k, v = _qkv(2, 256, 384)
    do = torch.zeros(2, 256, 384, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="design must be one of"):
        TA._launch_core_bwd(q, k, v, do, 1, True, design)
    with pytest.raises(ValueError, match="design must be one of"):
        TA.core_plan(256, 384, True, design)
    assert library.calls == []


def test_core_names_each_wide_backward_instance():
    """The wide backward instances ``kernel_attrs`` reports: the dq side,
    then the dk/dv side (K8b's at Dh 128 c), one for each count c of
    128-column chunks, 2-7."""
    wide = [n for n in TA.CORE_KERNELS if n.startswith("backward registers") and "-" in n]
    assert wide == [f"backward registers {lo}-{lo + 112} {side}" for side in ("dq", "dk dv")
                    for lo in range(144, 785, 128)]


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


@pytest.mark.parametrize("Dh,H", [(512, 2), (896, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k8b_matches_jax_at_dh_512_and_896(monkeypatch, dtype, Dh, H):
    """K8b's plain version (dq, dk, dv from o and lse, dsum from the rounded
    o), the oracle of the wide registers design on the card, against JAX's
    flash backward in interpret mode, both on JAX's forward outputs, at N =
    1024 and one image."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    N, D = 1024, H * Dh
    assert JF.flash_supported(1, N, D, H) and TF.flash_supported(N, Dh)
    r = np.random.default_rng(Dh + 3)
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
    assert TF.BWD_LAUNCHES.count == before  # CPU: the plain version
    for label, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.float().numpy(), w, dtype, f"K8b {label} {dtype} Dh {Dh}")


@pytest.mark.parametrize("att", [True, False])
@pytest.mark.parametrize("N", [48, 80, 272])
@pytest.mark.parametrize("Dh,dtype", [(136, "float32"), (256, "bfloat16"), (384, "float32")])
def test_plain_core_bwd_matches_jax_past_128_at_ragged_tiles(monkeypatch, dtype, Dh, N, att):
    """The backward core's plain versions (K2b's and K4's with att, K7b's
    without), the oracles of the wide registers design, against JAX's K7
    backward (``_fused_bwd`` -> ``_bwd_kernel``) and, for att, its forward
    (``_fused_fwd_call``), in interpret mode: one image, one head of 136
    (padded to 144 on the card), 256 or 384 columns, N leaving a ragged
    64-key tile."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    B, H = 1, 1
    assert TA.supported_tokens(N, Dh)
    r = np.random.default_rng(5 * N + Dh)
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
        _close(g.float().numpy(), w, dtype, f"{label} {dtype} (N={N}, Dh={Dh})")
