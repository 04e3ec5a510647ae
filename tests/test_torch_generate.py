"""``generate_torch.py`` end to end on the CPU, and the port's isolation from
JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import generate_torch  # noqa: E402
from ddm_tpu_torch.models.dit import init_params  # noqa: E402
from ddm_tpu_torch.models.factory import build_model  # noqa: E402
from ddm_tpu_torch.ops import attention as TA  # noqa: E402
from ddm_tpu_torch.ops import mlp_block as TM  # noqa: E402
from ddm_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CFG = {"image_size": 16, "patch_size": 4, "embed_dim": 128, "depth": 2, "heads": 2,
       "time_embed": 32, "sample_steps": 2, "eps_churn": 0.5}


@pytest.fixture()
def ckpt(tmp_path):
    model = init_params(build_model(CFG), torch.Generator().manual_seed(0))
    return save_checkpoint(str(tmp_path / "model_final.pt"), model.state_dict(), CFG)


def test_generate_end_to_end_on_cpu(ckpt, tmp_path):
    TM.LAUNCHES.reset()
    TA.LAUNCHES.reset()
    npz, png = tmp_path / "s.npz", tmp_path / "s.png"
    result = generate_torch.main(["--ckpt", ckpt, "--n", "5", "--batch", "4", "--steps", "2",
                                  "--device", "cpu", "--npz", str(npz), "--out", str(png)])
    samples = np.load(npz)["samples"]
    assert samples.shape == (5, 16, 16, 3) and samples.dtype == np.float32
    assert np.isfinite(samples).all() and samples.min() >= -1 and samples.max() <= 1
    np.testing.assert_array_equal(samples, result["samples"])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert TM.LAUNCHES.count == 0 and TA.LAUNCHES.count == 0  # CPU: plain versions

    # same seed, same samples; the run dir resolves to model_final.pt
    again = generate_torch.main(["--ckpt", str(tmp_path), "--n", "5", "--batch", "4",
                                 "--steps", "2", "--device", "cpu", "--out", ""])
    np.testing.assert_array_equal(again["samples"], samples)


def test_generate_resolves_the_latest_epoch_and_config_overlay(tmp_path):
    model = init_params(build_model(CFG), torch.Generator().manual_seed(0))
    for e in (1, 12, 3):
        save_checkpoint(str(tmp_path / f"model_epoch{e:03d}.pt"), model.state_dict(), CFG)
    assert generate_torch._resolve_ckpt(str(tmp_path)).endswith("model_epoch012.pt")
    overlay = tmp_path / "cfg.json"
    overlay.write_text('{"attention": "xla"}')
    built = []
    real = generate_torch.build_model
    with mock.patch.object(generate_torch, "build_model",
                           side_effect=lambda cfg, dev: built.append(real(cfg, dev)) or built[-1]):
        out = generate_torch.main(["--ckpt", str(tmp_path), "--config", str(overlay),
                                   "--n", "2", "--steps", "1", "--device", "cpu", "--out", ""])
    assert built[0].blocks[0].attention == "xla"  # the overlay reached the model
    assert np.isfinite(out["samples"]).all()


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--ema"], ["--dp", "4"]])
def test_generate_refuses_unported_flags(ckpt, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        generate_torch.main(["--ckpt", ckpt, "--device", "cpu", "--out", "", *flag])


def test_generate_on_cuda_without_a_gpu_exits(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        generate_torch.main(["--ckpt", ckpt, "--device", "cuda", "--out", ""])


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import ddm_tpu_torch, generate_torch, chip_smoke, train_cifar10_dit_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(ddm_tpu_torch.__path__, "
            "'ddm_tpu_torch.')]\n"
            "assert {'ddm_tpu_torch.training', 'ddm_tpu_torch.ops.energy', "
            "'ddm_tpu_torch.data.augment', 'ddm_tpu_torch.utils.config'} <= set(mods)\n"
            "for m in mods: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ddm_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)


def test_port_sources_have_no_jax_import():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|optax|ddm_tpu)\b", re.M)
    files = [*sorted((ROOT / "ddm_tpu_torch").rglob("*.py")),
             ROOT / "generate_torch.py", ROOT / "chip_smoke.py",
             ROOT / "train_cifar10_dit_torch.py"]
    assert len(files) > 20
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: chip_smoke.py runs there")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
