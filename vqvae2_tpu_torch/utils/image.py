"""Image-grid utilities (the port's own copy of ``vqvae2_tpu/utils/image.py``:
numpy and PIL only)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    padding: int = 2,
    normalize: bool = True,
    value_range: Optional[tuple] = (-1.0, 1.0),
) -> np.ndarray:
    """NHWC float batch → one HWC uint8 grid, ``nrow`` images a row, white
    padding around each."""
    images = np.asarray(images, dtype=np.float32)
    if images.ndim == 3:
        images = images[..., None]
    n, h, w, c = images.shape
    if c == 1:
        images = np.repeat(images, 3, axis=-1)
        c = 3

    if normalize:
        lo, hi = value_range if value_range else (images.min(), images.max())
        images = (images - lo) / max(hi - lo, 1e-5)
    images = np.clip(images, 0.0, 1.0)

    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    grid = np.ones(
        (nrows * (h + padding) + padding, ncol * (w + padding) + padding, c),
        dtype=np.float32,
    )
    for i in range(n):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return (grid * 255).astype(np.uint8)


def save_image(images, path: str, nrow: int = 8, **kwargs) -> None:
    """Save an NHWC batch as a PNG sample grid."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(make_grid(np.asarray(images), nrow=nrow, **kwargs)).save(path)
