"""The port's affine transforms (``utils/transforms.py``, numpy only) against
the JAX package's cv2 version: the 2x3 matrix (and its inverse) within
1e-12, the bilinear warp of N(0, 1) data within 1e-4 of the largest
magnitude among the image and the border (cv2 blends in fp32: with a border
of 255 it lies 2.9e-4 from the exact blend), the nearest warp of a label
map equal, the logits' warp back within 1e-4, and ``box2cs``
exactly, at rotations 0, 17 and -33 degrees and a constant border of 0 or
255."""

import numpy as np
import pytest

from vqvae2_tpu.utils import transforms as jt
from vqvae2_tpu_torch.utils import transforms as tt

ROTATIONS = (0, 17, -33)


@pytest.mark.parametrize("rot", ROTATIONS)
def test_matrices(rot):
    for box in ([5, 7, 30, 40], [0, 0, 64, 20], [12.5, 3, 7, 9]):
        c, s = tt.box2cs(box)
        for a, b in zip((c, s), jt.box2cs(box)):
            np.testing.assert_array_equal(a, b)
        for shift, inv in (((0, 0), False), ((0.1, -0.05), False), ((0, 0), True)):
            got = tt.get_affine_transform(c, s, rot, (32, 16), shift=shift, inv=inv)
            want = jt.get_affine_transform(c, s, rot, (32, 16), shift=shift, inv=inv)
            assert got.shape == (2, 3) and got.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("rot", ROTATIONS)
@pytest.mark.parametrize("border", [0, 255])
def test_warps(rot, border):
    g = np.random.default_rng(rot + 100)
    img = g.normal(size=(64, 48, 3)).astype(np.float32)
    gray = g.normal(size=(64, 48)).astype(np.float32)
    labels = g.integers(0, 20, size=(64, 48)).astype(np.uint8)
    c, s = tt.box2cs([5, 7, 30, 40])
    for x in (img, gray):
        got = tt.affine_image(x, c, s, rot, (32, 16), border=border)
        want = jt.affine_image(x, c, s, rot, (32, 16), border=border)
        assert got.shape == want.shape and got.dtype == want.dtype
        scale = max(float(np.abs(x).max()), border)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(scale, 1.0))
    got = tt.affine_image(labels, c, s, rot, (32, 16), nearest=True, border=border)
    np.testing.assert_array_equal(
        got, jt.affine_image(labels, c, s, rot, (32, 16), nearest=True, border=border))
    assert got.dtype == np.uint8 and (got == border).any()


def test_logits_back_to_the_image():
    g = np.random.default_rng(5)
    logits = g.normal(size=(32, 16, 7)).astype(np.float32)
    c, s = tt.box2cs([5, 7, 30, 40])
    got = tt.transform_logits(logits, c, s, 48, 64, (32, 16))
    want = jt.transform_logits(logits, c, s, 48, 64, (32, 16))
    assert got.shape == want.shape == (64, 48, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
