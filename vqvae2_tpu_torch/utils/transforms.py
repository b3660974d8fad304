"""Affine transforms for pose and parsing pre/post-processing (port of
``vqvae2_tpu/utils/transforms.py``), numpy only: host-side code that feeds
the model and reads its output back.

The JAX package calls cv2; here the same maps are computed directly:

* :func:`get_affine_transform` solves the 6x6 system for the 2x3 matrix
  that maps three source points onto three destination points
  (``cv2.getAffineTransform``) in float64;
* :func:`affine_image` and :func:`transform_logits` warp as
  ``cv2.warpAffine`` does with a constant border: each output pixel reads the
  input at the inverse-mapped point, bilinearly (neighbours outside the image
  take the border value) or at the nearest pixel (coordinates rounded, half
  up).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _get_dir(src_point, rot_rad: float) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.asarray([
        src_point[0] * cs - src_point[1] * sn,
        src_point[0] * sn + src_point[1] * cs,
    ], np.float32)


def _get_3rd_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    direct = a - b
    return b + np.asarray([-direct[1], direct[0]], np.float32)


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 float64 matrix ``M`` with ``M @ [x, y, 1] = [u, v]`` for the
    three point pairs (``cv2.getAffineTransform``)."""
    src = np.asarray(src, np.float64).reshape(3, 2)
    dst = np.asarray(dst, np.float64).reshape(3, 2)
    a = np.zeros((6, 6))
    a[0::2, 0:2], a[0::2, 2] = src, 1.0
    a[1::2, 3:5], a[1::2, 5] = src, 1.0
    return np.linalg.solve(a, dst.reshape(6)).reshape(2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """2x3 affine matrix mapping a (center, scale) person box onto
    ``output_size`` (h, w); with ``inv``, the inverse map."""
    center = np.asarray(center, np.float32)
    scale = np.asarray(scale if np.ndim(scale) else [scale, scale], np.float32)
    shift = np.asarray(shift, np.float32)

    src_w = scale[0]
    dst_h, dst_w = output_size

    rot_rad = np.pi * rot / 180
    src_dir = _get_dir([0, src_w * -0.5], rot_rad)
    dst_dir = np.asarray([0, (dst_w - 1) * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [(dst_w - 1) * 0.5, (dst_h - 1) * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _get_3rd_point(src[0], src[1])
    dst[2] = _get_3rd_point(dst[0], dst[1])

    if inv:
        return affine_from_points(dst, src)
    return affine_from_points(src, dst)


def box2cs(box: Sequence[float], aspect_ratio: float = 0.5
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y, w, h) box → (center, scale) with aspect snapping."""
    x, y, w, h = box[:4]
    center = np.asarray([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return center, np.asarray([w, h], np.float32)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.asarray([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                       [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def warp_affine(img: np.ndarray, m: np.ndarray, out_hw, nearest: bool = False,
                border=0) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), INTER_LINEAR or INTER_NEAREST,
    BORDER_CONSTANT, border)`` for an (H, W) or (H, W, C) image: output pixel
    (x, y) reads the input at ``invert(m) @ [x, y, 1]``.  The result has the
    input's type (integers rounded and saturated)."""
    img = np.asarray(img)
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    im = _invert_affine(m)
    ys, xs = np.mgrid[0:h_out, 0:w_out].astype(np.float64)
    sx = im[0, 0] * xs + im[0, 1] * ys + im[0, 2]
    sy = im[1, 0] * xs + im[1, 1] * ys + im[1, 2]
    src = img.astype(np.float64)
    if img.ndim == 2:
        src = src[..., None]
    h, w = img.shape[:2]
    # cv2 reads a number as the scalar (border, 0, 0, 0): the first channel
    # takes it, the others 0
    fill = np.zeros(src.shape[-1])
    given = np.atleast_1d(np.asarray(border, np.float64))[: src.shape[-1]]
    fill[: len(given)] = given

    def fetch(yi: np.ndarray, xi: np.ndarray) -> np.ndarray:
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(inside[..., None], vals, fill)

    if nearest:
        out = fetch(np.floor(sy + 0.5).astype(np.int64), np.floor(sx + 0.5).astype(np.int64))
    else:
        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        top = fetch(y0, x0) * (1 - fx) + fetch(y0, x0 + 1) * fx
        bottom = fetch(y0 + 1, x0) * (1 - fx) + fetch(y0 + 1, x0 + 1) * fx
        out = top * (1 - fy) + bottom * fy
    if img.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def affine_image(img: np.ndarray, center, scale, rot, output_size,
                 nearest: bool = False, border=0) -> np.ndarray:
    """Warp an image or label map into the crop frame."""
    trans = get_affine_transform(center, scale, rot, output_size)
    return warp_affine(img, trans, output_size, nearest=nearest, border=border)


def transform_logits(logits: np.ndarray, center, scale, width, height,
                     input_size) -> np.ndarray:
    """Warp model-space logits (H, W, C) back to the original image frame."""
    trans = get_affine_transform(center, scale, 0, input_size, inv=True)
    return warp_affine(logits, trans, (int(height), int(width)))
