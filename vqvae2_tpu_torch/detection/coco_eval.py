"""COCO-style detection and segmentation AP (port of
``vqvae2_tpu/detection/coco_eval.py``, numpy only): 101-point interpolated AP
over IoU 0.50:0.95 with the usual summary keys (mAP, AP50, AP75).  Box and
mask AP share one matcher; only the IoU differs, as in pycocotools.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _box_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.clip(a + b - inter, 1e-10, None)


def _mask_iou(mask: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """Binary mask IoU: (H,W) vs (G,H,W) → (G,)."""
    m = mask.astype(bool)
    ms = masks.astype(bool)
    inter = np.logical_and(m[None], ms).sum(axis=(1, 2))
    union = np.logical_or(m[None], ms).sum(axis=(1, 2))
    return inter / np.clip(union, 1e-10, None)


def _ap_per_class(dets, gts, iou_thr: float, iou_fn=_box_iou) -> float:
    """dets: list of (img_id, score, obj); gts: {img_id: stacked objs}.

    ``obj`` is a box (4,) or a mask (H,W) — ``iou_fn`` decides.
    """
    n_gt = sum(len(v) for v in gts.values())
    if n_gt == 0:
        return np.nan
    dets = sorted(dets, key=lambda d: -d[1])
    matched: Dict[int, np.ndarray] = {k: np.zeros(len(v), bool)
                                      for k, v in gts.items()}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img, score, obj) in enumerate(dets):
        g = gts.get(img)
        if g is None or len(g) == 0:
            fp[i] = 1
            continue
        ious = iou_fn(np.asarray(obj), g)
        j = int(np.argmax(ious))
        if ious[j] >= iou_thr and not matched[img][j]:
            matched[img][j] = True
            tp[i] = 1
        else:
            fp[i] = 1
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.clip(ctp + cfp, 1e-10, None)
    # precision envelope + 101-point interpolation (COCO style)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    return float(np.mean(np.interp(RECALL_POINTS, recall, precision,
                                   left=precision[0] if len(precision) else 0,
                                   right=0.0))) if len(precision) else 0.0


def _summarize(det_by_cls, gt_by_cls, iou_fn) -> Dict[str, float]:
    classes = sorted(gt_by_cls.keys())
    ap_matrix = np.full((len(classes), len(IOU_THRESHOLDS)), np.nan)
    for ci, c in enumerate(classes):
        for ti, thr in enumerate(IOU_THRESHOLDS):
            ap_matrix[ci, ti] = _ap_per_class(det_by_cls.get(c, []),
                                              gt_by_cls[c], thr, iou_fn)
    out = {
        "mAP": float(np.nanmean(ap_matrix)),
        "AP50": float(np.nanmean(ap_matrix[:, 0])),
        "AP75": float(np.nanmean(ap_matrix[:, 5])),
    }
    for ci, c in enumerate(classes):
        out[f"AP50_class_{c}"] = float(ap_matrix[ci, 0])
    return out


def evaluate_detections(
    predictions: Sequence[Tuple[int, np.ndarray, np.ndarray, np.ndarray]],
    ground_truth: Sequence[Tuple[int, np.ndarray, np.ndarray]],
) -> Dict[str, float]:
    """COCO-style box AP summary (pycocotools ``iouType='bbox'``).

    predictions: iterable of (image_id, boxes (N,4) ltrb, scores (N,),
    labels (N,)); ground_truth: iterable of (image_id, boxes (G,4),
    labels (G,)).  Returns {"mAP", "AP50", "AP75"} plus per-class AP50.
    """
    det_by_cls: Dict[int, List] = defaultdict(list)
    gt_by_cls: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)

    for img_id, boxes, labels in ground_truth:
        for c in np.unique(labels):
            gt_by_cls[int(c)][img_id] = np.asarray(boxes)[labels == c]
    for img_id, boxes, scores, labels in predictions:
        for b, s, c in zip(boxes, scores, labels):
            det_by_cls[int(c)].append((img_id, float(s), np.asarray(b)))
    return _summarize(det_by_cls, gt_by_cls, _box_iou)


def evaluate_segmentations(
    predictions: Sequence[Tuple[int, np.ndarray, np.ndarray, np.ndarray]],
    ground_truth: Sequence[Tuple[int, np.ndarray, np.ndarray]],
) -> Dict[str, float]:
    """COCO-style mask AP summary (pycocotools ``iouType='segm'``,
    the evaluation ``fashion.py`` runs via ``vision/coco_eval.py:20-200``).

    predictions: iterable of (image_id, masks (N,H,W) bool, scores (N,),
    labels (N,)); ground_truth: iterable of (image_id, masks (G,H,W) bool,
    labels (G,)).  Same matcher as box AP, binary-mask IoU.
    """
    det_by_cls: Dict[int, List] = defaultdict(list)
    gt_by_cls: Dict[int, Dict[int, np.ndarray]] = defaultdict(dict)

    for img_id, masks, labels in ground_truth:
        labels = np.asarray(labels)
        masks = np.asarray(masks)
        for c in np.unique(labels):
            gt_by_cls[int(c)][img_id] = masks[labels == c].astype(bool)
    for img_id, masks, scores, labels in predictions:
        for m, s, c in zip(masks, scores, labels):
            det_by_cls[int(c)].append((img_id, float(s),
                                       np.asarray(m).astype(bool)))
    return _summarize(det_by_cls, gt_by_cls, _mask_iou)
