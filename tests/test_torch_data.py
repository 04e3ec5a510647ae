"""The port's bilinear resize and its loaders against the JAX package's,
which resize with Pillow (``resize_images_pil``); the port imports no
Pillow (the GPU machine has none)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ddm_tpu.data.cifar10 import CIFAR10DataConfig as JaxDataConfig
from ddm_tpu.data.cifar10 import build_cifar10_dataloaders as jax_loaders
from ddm_tpu.data.cifar10 import resize_images_pil
from ddm_tpu_torch.data.cifar10 import (
    CIFAR10DataConfig,
    build_cifar10_dataloaders,
    resize_images_bilinear,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("size", [64, 128, 256])
def test_resize_is_bit_identical_to_pillow_bilinear(size):
    images = np.random.default_rng(size).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    got = resize_images_bilinear(images, size)
    assert got.dtype == np.uint8 and got.shape == (6, size, size, 3)
    np.testing.assert_array_equal(got, resize_images_pil(images, size))


def test_resize_matches_pillow_on_the_rounding_edges():
    """Saturated and flat images (the clip of each pass), and shrinking,
    where more than two taps feed each pixel."""
    r = np.random.default_rng(1)
    images = np.stack([np.zeros((32, 32, 3), np.uint8), np.full((32, 32, 3), 255, np.uint8),
                       (r.integers(0, 2, (32, 32, 3)) * 255).astype(np.uint8)])
    for size in (128, 24, 9):
        np.testing.assert_array_equal(resize_images_bilinear(images, size),
                                      resize_images_pil(images, size))


def test_loaders_resize_once_as_the_jax_loaders_do():
    cfg = dict(batch_size=8, image_size=64, synthetic=True, synthetic_size=24, seed=2)
    ours, ours_eval = build_cifar10_dataloaders(CIFAR10DataConfig(**cfg))
    theirs, theirs_eval = jax_loaders(JaxDataConfig(**cfg))
    ours.set_epoch(3)
    theirs.set_epoch(3)
    for (a, la), (b, lb) in zip(ours, theirs):
        assert a.shape == (8, 64, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(next(iter(ours_eval))[0], next(iter(theirs_eval))[0])


def test_port_imports_no_pillow():
    code = ("import importlib, pkgutil, sys\n"
            "import ddm_tpu_torch, generate_torch, chip_smoke, train_cifar10_dit_torch\n"
            "for m in pkgutil.walk_packages(ddm_tpu_torch.__path__, 'ddm_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'matplotlib'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)
