"""Prediction drawing (port of ``vqvae2_tpu/detection/visualize.py``, PIL
only): boxes, mask overlays and labels rendered into PNG files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

# distinct per-class colours (cycled)
_PALETTE = [
    (230, 25, 75), (60, 180, 75), (255, 225, 25), (0, 130, 200),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
    (210, 245, 60), (250, 190, 212), (0, 128, 128), (220, 190, 255),
]


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """HWC float in [-1,1] or [0,1], or uint8 → uint8 RGB."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        out = img
    else:
        img = img.astype(np.float32)
        if img.min() < -0.01:  # [-1, 1] convention of the data layer
            img = (img + 1.0) / 2.0
        out = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if out.ndim == 2:
        out = out[..., None]
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    return out


def draw_detections(
    img: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
    class_names: Optional[Dict[int, str]] = None,
    score_thresh: float = 0.5,
    mask_alpha: float = 0.4,
) -> np.ndarray:
    """Render detections onto one image → uint8 HWC.

    ``boxes`` are ltrb, fractional (all ≤ 1) or pixel; ``masks`` (N,H,W)
    full-size binary/probability masks blended at ``mask_alpha``
    (the ``cv2.addWeighted`` of reference ``fashion.py:150``).
    """
    from PIL import Image, ImageDraw

    canvas = _to_uint8(img).copy()
    h, w = canvas.shape[:2]
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    labels = np.asarray(labels).reshape(-1)
    scores = (np.ones(len(boxes)) if scores is None
              else np.asarray(scores).reshape(-1))
    if boxes.size and boxes.max() <= 1.001:  # fractional → pixel
        boxes = boxes * np.asarray([w, h, w, h], np.float32)

    order = np.argsort(scores)  # draw high scores last (on top)
    # mask overlays first, boxes/text above them
    if masks is not None:
        masks = np.asarray(masks)
        blend = canvas.astype(np.float32)
        for i in order:
            if scores[i] < score_thresh:
                continue
            color = np.asarray(_PALETTE[int(labels[i]) % len(_PALETTE)],
                               np.float32)
            m = (masks[i] > 0.5).astype(np.float32)[..., None] * mask_alpha
            blend = blend * (1 - m) + color * m
        canvas = blend.astype(np.uint8)

    im = Image.fromarray(canvas)
    draw = ImageDraw.Draw(im)
    for i in order:
        if scores[i] < score_thresh:
            continue
        color = _PALETTE[int(labels[i]) % len(_PALETTE)]
        x0, y0, x1, y1 = boxes[i]
        draw.rectangle([float(x0), float(y0), float(x1), float(y1)],
                       outline=color, width=2)
        name = (class_names or {}).get(int(labels[i]), str(int(labels[i])))
        text = f"{name}:{scores[i]:.2f}"
        ty = max(float(y0) - 11, 0)
        tw = draw.textlength(text) if hasattr(draw, "textlength") \
            else 6 * len(text)
        draw.rectangle([float(x0), ty, float(x0) + tw + 2, ty + 11],
                       fill=color)
        draw.text((float(x0) + 1, ty), text, fill=(0, 0, 0))
    return np.asarray(im)


def save_detections(
    path: str,
    img: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
    gt_boxes: Optional[np.ndarray] = None,
    gt_labels: Optional[np.ndarray] = None,
    **kwargs,
) -> None:
    """Write one annotated PNG; with GT given, a side-by-side [pred | GT]."""
    from PIL import Image

    pred = draw_detections(img, boxes, labels, scores, masks, **kwargs)
    if gt_boxes is not None:
        gt = draw_detections(img, gt_boxes, gt_labels,
                             class_names=kwargs.get("class_names"))
        pad = np.full((pred.shape[0], 4, 3), 255, np.uint8)
        pred = np.concatenate([pred, pad, gt], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(pred).save(path)
