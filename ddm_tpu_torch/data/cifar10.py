"""CIFAR-10 input pipeline on the host (numpy only).

Port of ``ddm_tpu/data/cifar10.py`` for one process: the dataset lives in
memory as uint8 NHWC arrays, the train loader yields raw uint8 batches
(augmentation and normalisation run on the device inside the training step,
:mod:`ddm_tpu_torch.data.augment`), and the shuffle is drawn statelessly
from ``(seed, epoch)`` with numpy, so the port sees the JAX package's data
order for the same seed.

The port reads synthetic data only: the real CIFAR-10 reader (the pickle
batches, with no download) and the PIL resize for ``image_size != 32`` are
ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

__all__ = [
    "CIFAR10DataConfig",
    "CIFAR10Arrays",
    "ArrayLoader",
    "build_cifar10_dataloaders",
]

_NOT_PORTED = "ROADMAP.md Queue 1 item 7 (data)"


@dataclass
class CIFAR10DataConfig:
    """Loader configuration (the JAX package's fields that the port reads)."""

    batch_size: int = 128
    image_size: int = 32
    drop_last: bool = True
    synthetic: bool = False
    synthetic_size: int = 2048
    seed: int = 0


@dataclass
class CIFAR10Arrays:
    """Memory-resident dataset: uint8 NHWC images + int labels."""

    images: np.ndarray  # (N, 32, 32, 3) uint8
    labels: np.ndarray  # (N,) int64


def _synthetic_cifar10(n: int, seed: int) -> CIFAR10Arrays:
    """Deterministic fake CIFAR-10-shaped data (class-colored noise blobs),
    the same arrays as the JAX package's for the same ``(n, seed)``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    base = (labels[:, None, None, None] * 25).astype(np.uint8)
    noise = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8) // 4
    images = np.clip(base + noise.astype(np.int32) * 3, 0, 255).astype(np.uint8)
    return CIFAR10Arrays(images=images, labels=labels.astype(np.int64))


class ArrayLoader:
    """Epoch loader over memory-resident arrays, yielding ``(images,
    labels)`` numpy batches. ``shuffle`` draws the epoch's permutation from
    ``(seed, epoch)`` (:meth:`set_epoch`); ``normalize`` converts images to
    float32 in [-1, 1], otherwise raw uint8 flows through."""

    def __init__(self, data: CIFAR10Arrays, batch_size: int, *, shuffle: bool,
                 drop_last: bool, normalize: bool, seed: int = 0) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be positive")
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.normalize = normalize
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle permutation to ``epoch``."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = self.data.images.shape[0]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = self.data.images.shape[0]
        if self.shuffle:
            order = np.random.default_rng((self._seed, self._epoch)).permutation(n)
            self._epoch += 1  # no-op for callers that set_epoch per epoch
        else:
            order = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            idx = order[i:i + self.batch_size]
            images = self.data.images[idx]
            if self.normalize:
                images = images.astype(np.float32) / 127.5 - 1.0
            yield images, self.data.labels[idx]


def build_cifar10_dataloaders(config: CIFAR10DataConfig) -> Tuple[ArrayLoader, ArrayLoader]:
    """Train loader (shuffled, ``drop_last`` per config, raw uint8) and test
    loader (ordered, float32 in [-1, 1]) over synthetic data."""
    if not config.synthetic:
        raise NotImplementedError(
            f"the PyTorch port reads synthetic CIFAR-10 only (pass --synthetic): {_NOT_PORTED}")
    if config.image_size != 32:
        raise NotImplementedError(
            f"image_size={config.image_size} needs the PIL resize of the loader: {_NOT_PORTED}")
    train = _synthetic_cifar10(config.synthetic_size, config.seed)
    test = _synthetic_cifar10(max(config.synthetic_size // 4, 2), config.seed + 1)
    return (
        ArrayLoader(train, config.batch_size, shuffle=True, drop_last=config.drop_last,
                    normalize=False, seed=config.seed),
        ArrayLoader(test, config.batch_size, shuffle=False, drop_last=False, normalize=True,
                    seed=config.seed + 1),
    )
