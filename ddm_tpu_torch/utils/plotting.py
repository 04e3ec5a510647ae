"""Image-grid PNG writer with no plotting library (stdlib ``zlib``/``struct``).

Port of ``ddm_tpu.utils.plotting.save_image_grid``: the same grid layout
(``nrow`` columns, default ``ceil(sqrt(B))``, ``padding`` pixels of white
between and around tiles, values clipped to [0, 1]), written as an 8-bit
RGB (or grayscale) PNG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["save_image_grid"]


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write_png(path: str, pixels: np.ndarray) -> None:
    """Write a (H, W, 3) or (H, W) uint8 array as a PNG."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3):
        raise ValueError("expecting a (H, W) or (H, W, 3) uint8 array")
    h, w = pixels.shape[:2]
    color = 2 if pixels.ndim == 3 else 0
    rows = np.ascontiguousarray(pixels).reshape(h, -1)
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(h))  # filter 0 per row
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_image_grid(images, path: str, nrow: int | None = None, padding: int = 2) -> None:
    """Tile images in [0, 1], shape ``(B, H, W, C)`` or ``(B, C, H, W)``, into
    a grid PNG."""
    imgs = np.asarray(images, dtype=np.float32)
    if imgs.ndim != 4:
        raise ValueError("Expecting a batch of images (rank 4)")
    if imgs.shape[1] in (1, 3) and imgs.shape[-1] not in (1, 3):
        imgs = imgs.transpose(0, 2, 3, 1)  # NCHW -> NHWC
    B, H, W, C = imgs.shape
    if C not in (1, 3):
        raise ValueError(f"expecting 1 or 3 channels, got {C}")
    if nrow is None:
        nrow = int(np.ceil(np.sqrt(B)))
    ncol = nrow
    nrow_grid = int(np.ceil(B / ncol))
    canvas = np.ones(
        (nrow_grid * (H + padding) + padding, ncol * (W + padding) + padding, C),
        dtype=np.float32,
    )
    for i in range(B):
        r, c = divmod(i, ncol)
        y = padding + r * (H + padding)
        x = padding + c * (W + padding)
        canvas[y:y + H, x:x + W] = np.clip(imgs[i], 0.0, 1.0)
    pixels = (canvas * 255.0).astype(np.uint8)
    _write_png(path, pixels[..., 0] if C == 1 else pixels)
