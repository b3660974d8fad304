"""The port's host augmentations (``train/vqvae_deep_bi.py``) against the JAX
package's, which warp with cv2 (absent where the port runs; present here):
``random_crop_boxes`` bit for bit, and the elastic warp, rewritten with
scipy, piece by piece and whole, with the same ``np.random.Generator`` draws
in the same order.

Tolerances, on 288x144x3 images drawn from N(0, 1):

* the blur of the displacement noise (``scipy.ndimage.gaussian_filter``,
  ``mode="mirror"``, 21 taps) within 1e-7 of ``cv2.GaussianBlur`` (measured
  3.0e-8: fp32 sums in another order);
* the bilinear sampling (``map_coordinates``, ``order=1``,
  ``mode="reflect"``) within 1e-6 of ``cv2.remap(..., BORDER_REFLECT)`` on the
  same coordinates (measured 4.8e-7; the displacements reach 4 px, so the
  border is sampled);
* the whole warp: the coordinates are float32 sums of the pixel grid and
  the blurred noise times alpha, so the blur's last-bit differences move a
  coordinate by up to alpha x 1e-7 px, or round it to the neighbouring
  float32 (3.1e-5 px near row 285): measured on 4.5 % of the x and 2.4 % of
  the y coordinates.  Where the two maps agree bit for bit the warps agree
  within 1e-6; every pixel within 1e-6 plus the coordinate differences times
  the image's largest difference between neighbouring pixels.
"""

import cv2
import numpy as np
import pytest

from vqvae2_tpu.train import vqvae_deep_bi as jbi
from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi

HW = (288, 144)
ALPHA, SIGMA = 25.0, 5.0


def images(seed, n=3, hw=HW):
    return np.random.default_rng(seed).normal(size=(n, *hw, 3)).astype(np.float32)


def cv2_maps(rng, h, w):
    """The JAX package's coordinates, drawn as its ``elastic_transform`` draws
    them (its lines, with cv2)."""
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    k = int(SIGMA * 4) | 1
    dx = cv2.GaussianBlur(rng.uniform(-1, 1, size=(h, w)).astype(np.float32), (k, k),
                          SIGMA) * ALPHA / w
    dy = cv2.GaussianBlur(rng.uniform(-1, 1, size=(h, w)).astype(np.float32), (k, k),
                          SIGMA) * ALPHA / h
    return gx + dx * w, gy + dy * h


def neighbour_step(img):
    """The largest difference between two neighbouring pixels, by axis."""
    return (float(np.abs(np.diff(img, axis=1)).max()), float(np.abs(np.diff(img, axis=0)).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_crop_boxes_is_bit_equal(seed):
    imgs = images(seed, n=6, hw=(96, 48))
    a, b = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    got, want = tbi.random_crop_boxes(imgs, a), jbi.random_crop_boxes(imgs, b)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, imgs)
    assert a.random() == b.random()                 # the same number of draws


def test_blur_matches_cv2():
    u = np.random.default_rng(3).uniform(-1, 1, size=HW).astype(np.float32)
    got = tbi.gaussian_blur(u, SIGMA)
    want = cv2.GaussianBlur(u, (21, 21), SIGMA)
    assert got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-7


def test_remap_matches_cv2_on_the_same_coordinates():
    img = images(4, n=1)[0]
    mx, my = cv2_maps(np.random.default_rng(5), *HW)
    assert max(float(np.abs(mx - np.arange(HW[1])).max()),
               float(np.abs(my - np.arange(HW[0])[:, None]).max())) > 2.0
    assert mx.min() < 0 or my.min() < 0 or mx.max() > HW[1] - 1 or my.max() > HW[0] - 1
    got = tbi.remap(img, mx, my)
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
    assert float(np.abs(got - want).max()) <= 1e-6


def test_coordinates_agree_to_the_blurs_rounding():
    a, b = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(3):
        got, want = tbi.elastic_maps(a, *HW, ALPHA, SIGMA), cv2_maps(b, *HW)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            step = np.spacing(np.abs(w).astype(np.float32))
            assert bool(np.all(np.abs(g - w) <= step + ALPHA * 1e-7))
            assert float(np.mean(g != w)) < 0.1
    assert a.random() == b.random()


@pytest.mark.parametrize("fn", ["elastic_transform", "aug_transforms"])
def test_the_warp_against_the_jax_packages(fn):
    """Both warps from one seed, and each image's two coordinate maps
    replayed from the same seed (the warp draws dx, then dy, image by image,
    before the boxes)."""
    imgs = images(7)
    a, b = np.random.default_rng(8), np.random.default_rng(8)
    got = getattr(tbi, fn)(imgs, a)
    want = getattr(jbi, fn)(imgs, b)
    assert a.random() == b.random()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    port_maps, jax_maps = np.random.default_rng(8), np.random.default_rng(8)
    for i in range(len(imgs)):
        (gx, gy), (wx, wy) = (tbi.elastic_maps(port_maps, *HW, ALPHA, SIGMA),
                              cv2_maps(jax_maps, *HW))
        same = (gx == wx) & (gy == wy)
        assert float(np.mean(same)) > 0.8
        err = np.abs(got[i] - want[i]).max(axis=-1)
        assert float(err[same].max()) <= 1e-6, i
        sx, sy = neighbour_step(imgs[i])
        assert bool(np.all(err <= 1e-6 + np.abs(gx - wx) * sx + np.abs(gy - wy) * sy)), i
