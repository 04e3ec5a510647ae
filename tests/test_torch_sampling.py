"""The port's reverse sampler against the JAX package's, step for step.

Random streams differ across frameworks, so numpy makes x_init and every
step's (xi, z), and both sides consume them in the sampler's order: the JAX
side as a Python loop over ``gaussian_bridge_mu_sigma`` and ``model.apply``
(the loop ``tests/test_sampling.py`` holds ``sample_dddm``'s scan to), the
port through ``sample_dddm(noise=...)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ddm_tpu.ops.attention as JA  # noqa: E402
import ddm_tpu.ops.mlp_block as JM  # noqa: E402
from ddm_tpu.models.dit import DDDMDiT as JaxDiT  # noqa: E402
from ddm_tpu.ops.schedules import gaussian_bridge_mu_sigma  # noqa: E402
from ddm_tpu_torch.models.dit import DDDMDiT  # noqa: E402
from ddm_tpu_torch.sampling import sample_dddm, sample_dddm_batched  # noqa: E402
from ddm_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

IMG, B, STEPS = 16, 8, 3
KW = dict(img_size=IMG, patch_size=4, embed_dim=128, depth=2, num_heads=2, time_embed_dim=32)


@pytest.fixture()
def jax_kernels_only(monkeypatch):
    monkeypatch.setenv("DDM_TPU_PALLAS_INTERPRET", "1")

    def boom(*a, **k):
        raise AssertionError("JAX took its plain version, not the Pallas kernel")

    monkeypatch.setattr(JM, "mlp_block_reference", boom)
    monkeypatch.setattr(JA, "attention_block_reference", boom)


@pytest.fixture(scope="module")
def models():
    jm = JaxDiT(**KW, dtype=jnp.float32, data_format="NHWC")
    x0 = jnp.zeros((1, IMG, IMG, 3))
    variables = jm.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,)), x0)
    pm = DDDMDiT(**KW, dtype=torch.float32)
    pm.load_state_dict(state_dict_from_jax(variables, patch_size=4))
    return jm, variables, pm.eval()


def _noise(seed):
    r = np.random.default_rng(seed)
    shape = (B, IMG, IMG, 3)
    x_init = r.standard_normal(shape).astype(np.float32)
    steps = [(r.standard_normal(shape).astype(np.float32),
              r.standard_normal(shape).astype(np.float32)) for _ in range(STEPS)]
    return x_init, steps


@pytest.mark.parametrize("eps_churn", [1.0, 0.0])
def test_sampler_matches_jax_loop(jax_kernels_only, models, eps_churn):
    jm, variables, pm = models
    x_init, steps = _noise(seed=int(eps_churn * 10))

    t_grid = jnp.linspace(0.0, 1.0, STEPS + 1)
    x = jnp.asarray(x_init)
    for (xi, z), k in zip(steps, reversed(range(STEPS))):
        s, t = t_grid[k], t_grid[k + 1]
        xhat0 = jm.apply(variables, x, jnp.full((B,), t), jnp.asarray(xi))
        mu, std = gaussian_bridge_mu_sigma(s, t, xhat0, x, eps_churn=eps_churn)
        x = mu + std * jnp.asarray(z)
    want = np.asarray(x)

    noise = (torch.from_numpy(x_init), [(torch.from_numpy(a), torch.from_numpy(b))
                                        for a, b in steps])
    got = sample_dddm(pm, B, steps=STEPS, eps_churn=eps_churn, data_shape=(IMG, IMG, 3),
                      noise=noise)
    assert got.dtype == torch.float32
    # fp32 forwards agree to ~1e-5 (tests/test_torch_model.py); three bridge
    # steps carry that through with coefficients of order one
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_sampler_is_seeded_by_its_generator(models):
    pm = models[2]
    draw = lambda seed: sample_dddm(  # noqa: E731
        pm, 2, steps=2, data_shape=(IMG, IMG, 3),
        generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_sampler_rejects_noise_of_the_wrong_length(models):
    x_init, steps = _noise(seed=3)
    with pytest.raises(ValueError, match="steps"):
        sample_dddm(models[2], B, steps=STEPS + 1, data_shape=(IMG, IMG, 3),
                    noise=(torch.from_numpy(x_init), steps))


def test_batched_sampler_pads_and_trims(models):
    calls = []

    def denoiser(x, t, xi):
        calls.append(x.shape[0])
        return torch.zeros_like(x)

    out = sample_dddm_batched(denoiser, 5, steps=2, data_shape=(2,), chunk_size=2,
                              generator=torch.Generator().manual_seed(0))
    assert out.shape == (5, 2) and np.isfinite(out).all()
    assert calls == [2] * 6  # three chunks of one shape, two steps each
