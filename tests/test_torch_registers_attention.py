"""The registers designs of the two attention forwards, the core of K2f and
K7f (``csrc/attention.cu`` ``attention_core_regs_kernel`` up to a padded
head of 128, ``attention_core_wide_kernel`` past it) and K8f
(``csrc/flash.cu`` ``flash_fwd_regs_kernel`` at Dh 32, 64 and 128,
``flash_fwd_wide_regs_kernel`` at Dh 256-896), on the CPU.

- The Python side: ``design=`` names reach the library as its codes (a
  stand-in library records them), the plan's own pick passes -1, "tiles"
  at the wide widths forcing K8f's chunked kernel, and an unknown name
  raises before any launch.
- The plain versions that the card holds the new kernels to
  (``tests/test_torch_cuda.py``, ``chip_smoke.py``) against the JAX kernels
  in Pallas interpret mode at the shapes the new designs stress: token
  counts that leave a ragged 64-key tile (16, 48, 80, 144, 272), head widths
  padded to a multiple of 16 (24, 72, 136 -> 144: a last 128-column chunk
  of 16), whole wide heads (256, 384), and K8 at Dh 32, 128, 256 and 512.
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


def _qkv(B, N, D, dtype=torch.bfloat16):
    return torch.zeros(B, N, 3 * D, dtype=dtype).split(D, dim=-1)


@pytest.mark.parametrize("design,code", [(None, -1), ("resident", 0), ("streamed", 1),
                                         ("registers", 2)])
def test_core_design_names_reach_the_library_as_its_codes(library, design, code):
    """The core's launcher passes the plan's code for each name of
    FWD_DESIGNS (argument 11 of ``ddm_attention_core``), through K2's core
    and K2f's chain too."""
    assert TA.FWD_DESIGNS.index("registers") == 2
    q, k, v = _qkv(2, 48, 72 * 2)
    TA._launch_core(q, k, v, 2, design)
    qkv = torch.zeros(2, 48, 3 * 144, dtype=torch.bfloat16)
    TA._k2_core(qkv, 2, design)
    (n1, a1), (n2, a2) = library.calls
    assert n1 == n2 == "ddm_attention_core"
    assert a1[10] == a2[10] == code
    assert a1[5:10] == (2, 48, 2, 72, 72 ** -0.5)


@pytest.mark.parametrize("design", ["registers ", "Registers", "tiles", "one-block", ""])
def test_core_refuses_an_unknown_design_before_launching(library, design):
    q, k, v = _qkv(2, 64, 128)
    with pytest.raises(ValueError, match="design must be one of"):
        TA._launch_core(q, k, v, 2, design)
    assert library.calls == []


@pytest.mark.parametrize("design,code", [(None, -1), ("tiles", 0), ("registers", 1)])
@pytest.mark.parametrize("Dh", TF.NARROW_DIMS + TF.REGISTERS_DIMS)
def test_k8f_design_names_reach_the_library_as_its_codes(library, design, code, Dh):
    """``launch_k8f(design=)`` passes ``ddm_flash_fwd`` the code of each
    name of FWD_DESIGNS (argument 11), and counts the launch: at the narrow
    widths too, where "registers" is the narrow registers design and the
    launcher's pick."""
    H = 256 // Dh
    q, k, v = _qkv(1, 1024, H * Dh)
    before = TF.FWD_LAUNCHES.count
    o, lse = TF.launch_k8f(q, k, v, H, Dh ** -0.5, design)
    (name, args), = library.calls
    assert name == "ddm_flash_fwd" and args[11] == code
    assert args[6:10] == (1, 1024, H, Dh)
    assert o.shape == (1, 1024, H * Dh) and lse.shape == (1, H, 1024)
    assert TF.FWD_LAUNCHES.count == before + 1


@pytest.mark.parametrize("design", ["register", "wgmma", "resident"])
def test_k8f_refuses_an_unknown_design_before_launching(library, design):
    q, k, v = _qkv(1, 1024, 128)
    before = TF.FWD_LAUNCHES.count
    with pytest.raises(ValueError, match="design must be one of"):
        TF.launch_k8f(q, k, v, 2, 64 ** -0.5, design)
    assert library.calls == [] and TF.FWD_LAUNCHES.count == before


@pytest.mark.parametrize("design", ["register", "narrow", "tiles "])
@pytest.mark.parametrize("Dh", TF.NARROW_DIMS)
def test_k8f_refuses_an_unknown_design_at_the_narrow_widths(library, design, Dh):
    """An unknown name raises before any launch at Dh 4, 8 and 16 as at the
    other widths (q, k and v read in place from a [q | k | v] buffer)."""
    H = 384 // Dh
    q, k, v = _qkv(1, 1024, H * Dh)
    before = TF.FWD_LAUNCHES.count
    with pytest.raises(ValueError, match="design must be one of"):
        TF.launch_k8f(q, k, v, H, Dh ** -0.5, design)
    assert library.calls == [] and TF.FWD_LAUNCHES.count == before


def test_kernel_attrs_name_every_instance(library):
    """``kernel_attrs`` reads one (registers, local bytes) pair per name: the
    seven resident and streamed kernels, then each registers instance of the
    forward (three a width) and of the backward (five a width), then the
    forward's nine wide registers instances, then the backward's wide dq and
    dk/dv sides (six each); K8's: the forward's two designs, then each
    backward design's two kernels, then the same at the wide widths, then at
    Dh 16 the one instance of each that takes Dh 4, 8 and 16."""
    attrs = TA.kernel_attrs()
    assert list(attrs) == list(TA.CORE_KERNELS)
    assert len(TA.CORE_KERNELS) == 7 + (3 + 5) * len(TA.REGISTERS_WIDTHS) + 9 + 2 * 6
    assert TA.REGISTERS_WIDTHS == (16, 32, 48, 64, 80, 96, 112, 128)
    assert library.calls[0][0] == "ddm_attention_kernel_attrs"
    flash = TF.kernel_attrs()
    fwd = lambda dims: [(d, dh) for d in ("registers", "tiles") for dh in dims]  # noqa: E731
    bwd = lambda dims: [(f"{d} {side}", dh) for d in ("registers", "tiles")  # noqa: E731
                        for side in ("dq", "dk dv") for dh in dims]
    wide = (256, 384, 512, 640, 768, 896)
    assert list(flash) == (fwd((32, 64, 128)) + bwd((32, 64, 128)) + fwd(wide) + bwd(wide)
                           + fwd((16,)) + bwd((16,)))
    assert TF.NARROW_DIMS == (4, 8, 16)
    assert library.calls[1][0] == "ddm_flash_kernel_attrs"


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


# (B, N, H, Dh): ragged last key tiles (N % 64 = 16, 48, 16, 16, 16) and
# query tiles, with whole (64), padded (24 -> 32, 72 -> 80) and narrow (8)
# heads; N <= 128 holds the scores in registers on the card, past it the
# two sweeps run; then past a padded head of 128 (the wide design): a head
# padded to 144 (a last 128-column chunk of 16) and whole ones of two and
# three chunks (256, 384) at N 48, 80 and 272
CORE_SHAPES = [(2, 16, 4, 24), (2, 48, 2, 72), (2, 80, 2, 64), (2, 80, 3, 8),
               (2, 144, 16, 24), (1, 272, 2, 24), (1, 272, 1, 72), (2, 48, 1, 136),
               (2, 80, 2, 136), (1, 272, 1, 136), (2, 48, 1, 256), (1, 80, 2, 256),
               (1, 272, 1, 256), (2, 48, 1, 384), (1, 80, 1, 384), (1, 272, 1, 384)]


@pytest.mark.parametrize("B,N,H,Dh", CORE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_core_matches_jax_at_ragged_tiles_and_padded_heads(monkeypatch, dtype, B, N, H,
                                                                  Dh):
    """The core's plain version (``attention_core_fwd`` on CPU tensors, the
    oracle of the card's registers design) against JAX's K7f body
    (``_fused_fwd_call``, the same core as K2f's) in interpret mode."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    assert TA.supported_tokens(N, Dh)
    r = np.random.default_rng(N + Dh)
    q, k, v = (r.standard_normal((B, N, H * Dh)).astype(np.float32) for _ in range(3))
    want = np.asarray(JA._fused_fwd_call(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                                         H, Dh ** -0.5), np.float32)
    before = TA.CORE_LAUNCHES.count
    got = TA.attention_core_fwd(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                  for a in (q, k, v)), H)
    assert TA.CORE_LAUNCHES.count == before  # CPU: the plain version
    _close(got.float().numpy(), want, dtype, f"core {dtype} (B={B}, N={N}, H={H}, Dh={Dh})")


@pytest.mark.parametrize("Dh,H", [(32, 4), (128, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k8f_matches_jax_at_dh_32_and_128(monkeypatch, dtype, Dh, H):
    """K8f's plain version (o and lse) against JAX's flash forward in
    interpret mode at N = 1024 and the registers design's two other widths
    (tests/test_torch_flash.py covers Dh 64)."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    N, D = 1024, H * Dh
    assert JF.flash_supported(1, N, D, H) and TF.flash_supported(N, Dh)
    r = np.random.default_rng(Dh)
    q, k, v = (r.standard_normal((1, N, D)).astype(np.float32) for _ in range(3))
    o, res = JF._flash_fwd(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), H,
                           Dh ** -0.5)
    hp = JF._heads_per_group(Dh)  # lse is (B * H / hp, N, hp)
    want_lse = np.asarray(res[4]).reshape(1, H // hp, N, hp).transpose(0, 1, 3, 2).reshape(1, H, N)
    got_o, got_lse = TF.flash_attention_fwd(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                              for a in (q, k, v)), H)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=0)
    _close(got_o.float().numpy(), np.asarray(o, np.float32), dtype, f"K8f o {dtype} Dh {Dh}")


# ---- the wide registers designs (K8f at Dh 256-896, the core past padded 128) ----


def test_wide_widths_are_every_k8_width_past_128():
    assert TF.WIDE_DIMS == tuple(d for d in TF.HEAD_DIMS if d > 128)
    assert not set(TF.WIDE_DIMS) & set(TF.REGISTERS_DIMS)


@pytest.mark.parametrize("design,code", [(None, -1), ("tiles", 0), ("registers", 1)])
@pytest.mark.parametrize("Dh", TF.WIDE_DIMS)
def test_k8f_wide_design_names_reach_the_library_as_its_codes(library, design, code, Dh):
    """At every wide width ``launch_k8f(design=)`` passes ``ddm_flash_fwd``
    the code of each name (argument 11): the registers design is the wide
    registers kernel, the library's own pick (-1); "tiles" forces the
    chunked kernel. Each launch counts once."""
    H = 2
    q, k, v = _qkv(1, 1024, H * Dh)
    before = TF.FWD_LAUNCHES.count
    o, lse = TF.launch_k8f(q, k, v, H, Dh ** -0.5, design)
    (name, args), = library.calls
    assert name == "ddm_flash_fwd" and args[11] == code
    assert args[3] == 3 * H * Dh  # q, k and v read in place from the [q | k | v] rows
    assert args[6:10] == (1, 1024, H, Dh) and args[10] == pytest.approx(Dh ** -0.5)
    assert o.shape == (1, 1024, H * Dh) and lse.shape == (1, H, 1024)
    assert TF.FWD_LAUNCHES.count == before + 1


@pytest.mark.parametrize("design", ["wide", "registers-wide", "Tiles", "resident"])
@pytest.mark.parametrize("Dh", [256, 896])
def test_k8f_wide_refuses_an_unknown_design_before_launching(library, design, Dh):
    q, k, v = _qkv(1, 1024, Dh)
    before = TF.FWD_LAUNCHES.count
    with pytest.raises(ValueError, match="design must be one of"):
        TF.launch_k8f(q, k, v, 1, Dh ** -0.5, design)
    assert library.calls == [] and TF.FWD_LAUNCHES.count == before


@pytest.mark.parametrize("design,code", [(None, -1), ("resident", 0), ("streamed", 1),
                                         ("registers", 2)])
@pytest.mark.parametrize("N,H,Dh", [(80, 2, 136), (64, 1, 768), (256, 1, 384),
                                    (256, 2, 512), (256, 4, 256), (16, 1, 896)])
def test_core_wide_design_names_reach_the_library_as_its_codes(library, design, code, N, H,
                                                                Dh):
    """Past a padded head of 128 (the three few-head paths' widths 384, 512
    and 768, DiT-B/4 --heads 3's 256, a padded 136 and the widest the
    registers design takes, 896) the core's launcher passes the plan's code
    of each name (argument 11 of ``ddm_attention_core``), through K2's core
    and K2f's chain too; the library picks the wide registers kernel for
    "registers" and for None."""
    q, k, v = _qkv(2, N, H * Dh)
    TA._launch_core(q, k, v, H, design)
    TA._k2_core(torch.zeros(2, N, 3 * H * Dh, dtype=torch.bfloat16), H, design)
    (n1, a1), (n2, a2) = library.calls
    assert n1 == n2 == "ddm_attention_core"
    assert a1[10] == a2[10] == code
    assert a1[5:9] == a2[5:9] == (2, N, H, Dh) and a1[9] == pytest.approx(Dh ** -0.5)


@pytest.mark.parametrize("design", ["wide", "registers-wide", "tiles", "two-pass", ""])
def test_core_wide_refuses_an_unknown_design_before_launching(library, design):
    q, k, v = _qkv(2, 256, 384)
    with pytest.raises(ValueError, match="design must be one of"):
        TA._launch_core(q, k, v, 1, design)
    assert library.calls == []


def test_core_names_each_wide_instance():
    """The wide instances ``kernel_attrs`` reports: each 128-column chunk
    count's padded widths on 8 warps (32 query rows a block), then the first
    three's on 16 (64 rows)."""
    wide = [n for n in TA.CORE_KERNELS if n.startswith("forward registers") and "-" in n]
    assert wide == [f"forward registers {lo}-{lo + 112} {rows} rows" for rows, los in (
        (32, range(144, 785, 128)), (64, (144, 272, 400))) for lo in los]


@pytest.mark.parametrize("Dh", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k8f_matches_jax_at_wide_heads(monkeypatch, dtype, Dh):
    """K8f's plain version (o and lse), the oracle of the wide registers
    design on the card, against JAX's flash forward in interpret mode at N =
    1024, B = 1 and one head of 256 and of 512 columns."""
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")
    N, H = 1024, 1
    assert JF.flash_supported(1, N, Dh, H) and TF.flash_supported(N, Dh)
    r = np.random.default_rng(Dh + 1)
    q, k, v = (r.standard_normal((1, N, Dh)).astype(np.float32) for _ in range(3))
    o, res = JF._flash_fwd(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)), H,
                           Dh ** -0.5)
    want_lse = np.asarray(res[4]).reshape(1, H, N)
    before = TF.FWD_LAUNCHES.count
    got_o, got_lse = TF.flash_attention_fwd(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                              for a in (q, k, v)), H)
    assert TF.FWD_LAUNCHES.count == before  # CPU: the plain version
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5, atol=0)
    _close(got_o.float().numpy(), np.asarray(o, np.float32), dtype, f"K8f o {dtype} Dh {Dh}")
