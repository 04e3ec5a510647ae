"""On-device CIFAR-10 augmentation (reflect-pad random crop + flip + normalize).

Port of ``ddm_tpu/data/augment.py``: the raw uint8 NHWC batch goes to the
device and the augmentation is a handful of tensor ops there: normalise to
[-1, 1], reflect-pad by 4, crop back to the original size at a random offset
per sample (two index gathers), flip horizontally with p = 0.5. The random
numbers come from an explicit ``torch.Generator`` on the batch's device, or
are injected (``offsets``, ``flips``), so a test can feed both packages the
same crops.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["normalize_images", "augment_cifar10"]

PAD = 4  # reflect padding before the crop (reference RandomCrop(32, padding=4))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (reference Normalize(0.5, 0.5))."""
    return images.float() / 127.5 - 1.0


def augment_cifar10(
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    offsets: Optional[torch.Tensor] = None,
    flips: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Augment a uint8 NHWC batch on its device; returns float32 NHWC in
    [-1, 1]. ``offsets`` ((B, 2) ints in [0, 2 PAD]) and ``flips`` ((B,)
    bools) replace the draws from ``generator``."""
    B, H, W, _ = images.shape
    dev = images.device
    x = normalize_images(images)
    x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (PAD, PAD, PAD, PAD),
                                mode="reflect").permute(0, 2, 3, 1)
    if offsets is None:
        offsets = torch.randint(0, 2 * PAD + 1, (B, 2), generator=generator, device=dev)
    offsets = offsets.to(dev)
    rows = offsets[:, 0:1] + torch.arange(H, device=dev)[None, :]  # (B, H)
    cols = offsets[:, 1:2] + torch.arange(W, device=dev)[None, :]  # (B, W)
    batch = torch.arange(B, device=dev)[:, None, None]
    x = x[batch, rows[:, :, None], cols[:, None, :]]
    if flips is None:
        flips = torch.rand((B,), generator=generator, device=dev) < 0.5
    return torch.where(flips.to(dev)[:, None, None, None], x.flip(2), x).contiguous()
