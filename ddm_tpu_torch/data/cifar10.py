"""CIFAR-10 input pipeline on the host (numpy only).

Port of ``ddm_tpu/data/cifar10.py`` for one process: the dataset lives in
memory as uint8 NHWC arrays, the train loader yields raw uint8 batches
(augmentation and normalisation run on the device inside the training step,
:mod:`ddm_tpu_torch.data.augment`), and the shuffle is drawn statelessly
from ``(seed, epoch)`` with numpy, so the port sees the JAX package's data
order for the same seed.

For ``image_size != 32`` the loaders resize the dataset once, as the JAX
package's do, with :func:`resize_images_bilinear`: Pillow's bilinear
resample written out in numpy (no Pillow import), bit-identical to it.

The port reads synthetic data only: the real CIFAR-10 reader (the pickle
batches, with no download) is ROADMAP.md Queue 1 item 7.
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
    "resize_images_bilinear",
]

_NOT_PORTED = "ROADMAP.md Queue 1 item 7 (data)"
_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


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


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fixed-point weights of Pillow's bilinear filter,
    computed as ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` in
    Pillow's ``libImaging/Resample.c`` do: taps around each output pixel's
    centre, normalised in float64, then rounded to 22 fractional bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ss = 1.0 / filterscale
    weights = np.zeros((in_size, out_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = [max(1.0 - abs((x - center + 0.5) * ss), 0.0) for x in range(xmin, xmax)]
        total = 0.0
        for w in taps:
            total += w
        for x, w in zip(range(xmin, xmax), taps):
            w = w / total if total != 0.0 else w
            weights[x, xx] = int((-0.5 if w < 0 else 0.5) + w * (1 << _PRECISION_BITS))
    return weights


def _resample_last_axis(a: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One 8-bit pass of Pillow's resample over the last axis of ``a``:
    integer sums of pixel x weight plus half a unit, shifted down by 22
    bits and clipped to uint8. Every step is exact in float64 (the sums
    stay below 2^31), so the sums run as one matmul."""
    acc = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, a.shape[-1]) @ weights
    acc += 1 << (_PRECISION_BITS - 1)
    acc *= 1.0 / (1 << _PRECISION_BITS)
    np.floor(acc, out=acc)
    np.clip(acc, 0, 255, out=acc)
    return acc.astype(np.uint8).reshape(a.shape[:-1] + (weights.shape[1],))


def resize_images_bilinear(images: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of a uint8 NHWC stack to ``size`` x ``size``,
    bit-identical to ``PIL.Image.resize(..., Image.BILINEAR)`` (the JAX
    package's ``resize_images_pil``): separable, horizontal pass first,
    each pass rounded and clipped to uint8."""
    n, h, w, c = images.shape
    wx, wy = _bilinear_weights(w, size), _bilinear_weights(h, size)
    out = np.empty((n, size, size, c), dtype=np.uint8)
    step = max(1, (1 << 22) // (size * max(h, size) * c))  # bounds the float64 scratch
    for i in range(0, n, step):
        rows = _resample_last_axis(images[i:i + step].transpose(0, 1, 3, 2), wx)  # n, h, c, x
        cols = _resample_last_axis(rows.transpose(0, 3, 2, 1), wy)  # n, x, c, y
        out[i:i + step] = cols.transpose(0, 3, 1, 2)
    return out


class ArrayLoader:
    """Epoch loader over memory-resident arrays, yielding ``(images,
    labels)`` numpy batches. ``shuffle`` draws the epoch's permutation from
    ``(seed, epoch)`` (:meth:`set_epoch`); ``normalize`` converts images to
    float32 in [-1, 1], otherwise raw uint8 flows through. ``image_size !=
    32`` resizes the dataset once, on construction, with the JAX loader's
    trigger (the reference transform's ``Resize`` whenever the size is not
    32, whatever the arrays' own size)."""

    def __init__(self, data: CIFAR10Arrays, batch_size: int, *, shuffle: bool,
                 drop_last: bool, normalize: bool, image_size: int = 32,
                 seed: int = 0) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be positive")
        if image_size != 32:
            data = CIFAR10Arrays(images=resize_images_bilinear(data.images, image_size),
                                 labels=data.labels)
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
    train = _synthetic_cifar10(config.synthetic_size, config.seed)
    test = _synthetic_cifar10(max(config.synthetic_size // 4, 2), config.seed + 1)
    return (
        ArrayLoader(train, config.batch_size, shuffle=True, drop_last=config.drop_last,
                    normalize=False, image_size=config.image_size, seed=config.seed),
        ArrayLoader(test, config.batch_size, shuffle=False, drop_last=False, normalize=True,
                    image_size=config.image_size, seed=config.seed + 1),
    )
