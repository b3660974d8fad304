"""Procedural structured-image dataset for convergence runs and demos (own
copy of ``vqvae2_tpu/data/shapes.py``; numpy only).

Renders a deterministic corpus with the structure of real images (smooth
gradients, flat regions, sharp shape boundaries) that a VQ-VAE must actually
model: reconstruction grids and prior samples over it are visually checkable,
unlike Gaussian noise.

Everything is vectorized numpy; each index renders independently from its own
seed (per-index deterministic → safe for thread-pool ``workers`` in
``iterate_batches``).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from vqvae2_tpu_torch.data.datasets import normalize_to_unit

_SHAPE_KINDS = ("circle", "rect", "triangle")


def _smooth(sdf: np.ndarray, edge: float) -> np.ndarray:
    """Signed distance -> anti-aliased coverage in [0, 1]."""
    return np.clip(sdf / edge + 0.5, 0.0, 1.0)


def render_shapes_image(index: int, size: int = 256, seed: int = 0,
                        max_shapes: int = 3) -> np.ndarray:
    """Render one uint8 HWC image: 2-color gradient background + 1..max_shapes
    anti-aliased colored shapes (circle / rectangle / triangle)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, size),
                         np.linspace(0.0, 1.0, size), indexing="ij")
    edge = 1.5 / size

    # Background: linear gradient between two colors along a random direction.
    c0, c1 = rng.uniform(0.25, 1.0, size=(2, 3))
    ang = rng.uniform(0.0, 2 * np.pi)
    t = (xx * np.cos(ang) + yy * np.sin(ang))
    t = (t - t.min()) / (t.max() - t.min() + 1e-9)
    img = c0[None, None, :] * (1 - t[..., None]) + c1[None, None, :] * t[..., None]

    n_shapes = int(rng.integers(1, max_shapes + 1))
    for _ in range(n_shapes):
        kind = _SHAPE_KINDS[int(rng.integers(len(_SHAPE_KINDS)))]
        color = rng.uniform(0.0, 1.0, size=3)
        cx, cy = rng.uniform(0.15, 0.85, size=2)
        r = rng.uniform(0.08, 0.28)
        if kind == "circle":
            sdf = r - np.hypot(xx - cx, yy - cy)
        elif kind == "rect":
            w, h = rng.uniform(0.6, 1.4, size=2) * r
            sdf = np.minimum(w - np.abs(xx - cx), h - np.abs(yy - cy))
        else:  # triangle: intersection of three half-planes around (cx, cy)
            angs = np.sort(rng.uniform(0.0, 2 * np.pi, size=3))
            vx = cx + r * np.cos(angs)
            vy = cy + r * np.sin(angs)
            sdf = np.full_like(xx, np.inf)
            for i in range(3):
                x0, y0 = vx[i], vy[i]
                x1, y1 = vx[(i + 1) % 3], vy[(i + 1) % 3]
                nx, ny = y1 - y0, x0 - x1  # inward normal (vertices are CCW)
                norm = np.hypot(nx, ny) + 1e-9
                sdf = np.minimum(sdf, ((xx - x0) * nx + (yy - y0) * ny) / norm)
        alpha = _smooth(sdf, edge)[..., None]
        img = img * (1 - alpha) + color[None, None, :] * alpha

    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


class ShapesDataset:
    """In-memory procedural dataset with the (img, class_idx, relpath) item
    protocol of ``ImageFileDataset``. Images render lazily (deterministic per
    index) and are cached as uint8 in RAM."""

    def __init__(self, n: int = 2048, size: int = 256, seed: int = 0,
                 cache: bool = True, raw: bool = False):
        self.n, self.size, self.seed = n, size, seed
        self.num_classes = 1
        self.raw = raw  # True → items stay uint8 (normalize on device)
        self._cache: dict = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def _render(self, i: int) -> np.ndarray:
        if self._cache is not None:
            got = self._cache.get(i)
            if got is None:
                # benign under threads: worst case two threads render the
                # same index and one overwrites the other with equal data
                got = self._cache[i] = render_shapes_image(
                    i, self.size, self.seed)
            return got
        return render_shapes_image(i, self.size, self.seed)

    def __getitem__(self, i: int):
        img = self._render(i)
        if not self.raw:
            img = normalize_to_unit(img)
        return (img, 0, f"shapes/{i:06d}.png")


def save_shapes_dataset(root: str, n: int = 2048, size: int = 256,
                        seed: int = 0) -> str:
    """Materialize the corpus as PNGs under ``root`` (ImageFileDataset
    layout)."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i in range(n):
        path = os.path.join(root, f"{i:06d}.png")
        if not os.path.exists(path):
            Image.fromarray(render_shapes_image(i, size, seed)).save(path)
    return root
