"""SSD box machinery (port of ``vqvae2_tpu/detection/boxes.py``): default
boxes, box conversions and IoU, target matching, decoding, host-side NMS and
the MultiBox loss.

Boxes are normalized ltrb ``(..., 4)`` as in the JAX package.  The torch
functions take a leading batch axis where the JAX ones are vmapped over one.

Two orders of the JAX package's computation carry over exactly:

* **Scatter with repeated indices.**  ``.at[idx].set(values)`` writes its
  updates in order on the CPU, so where several ground truths claim one box
  the last one wins (a padded row, whose IoUs are all -1, claims box 0).
  ``torch``'s ``index_put_`` leaves that order undefined on CUDA, so the
  winner is computed instead: the highest ground-truth index per box, by
  ``scatter_reduce("amax")`` (:func:`last_writer`).
* **Stable sorts.**  ``jnp.argsort`` is stable; the hard-negative rank of
  :func:`multibox_loss` uses ``torch.argsort(stable=True)``.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def default_boxes_ssd300(
    fig_size: int = 300,
    feat_sizes: Sequence[int] = (38, 19, 10, 5, 3, 1),
    steps: Sequence[int] = (8, 16, 32, 64, 100, 300),
    scales: Sequence[int] = (21, 45, 99, 153, 207, 261, 315),
    aspect_ratios: Sequence[Sequence[int]] = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
) -> np.ndarray:
    """SSD300 default boxes in (cx, cy, w, h), normalized.  Returns (8732, 4)
    float32."""
    boxes = []
    for idx, sfeat in enumerate(feat_sizes):
        sk1 = scales[idx] / fig_size
        sk2 = scales[idx + 1] / fig_size
        sk3 = math.sqrt(sk1 * sk2)
        all_sizes = [(sk1, sk1), (sk3, sk3)]
        for alpha in aspect_ratios[idx]:
            w, h = sk1 * math.sqrt(alpha), sk1 / math.sqrt(alpha)
            all_sizes.append((w, h))
            all_sizes.append((h, w))
        for w, h in all_sizes:
            for i, j in itertools.product(range(sfeat), repeat=2):
                cx, cy = (j + 0.5) * steps[idx] / fig_size, \
                         (i + 0.5) * steps[idx] / fig_size
                boxes.append((cx, cy, w, h))
    return np.clip(np.asarray(boxes, np.float32), 0.0, 1.0)


def ltrb_from_cxcywh(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def cxcywh_from_ltrb(b: torch.Tensor) -> torch.Tensor:
    l, t, r, bt = b.unbind(-1)
    return torch.stack([(l + r) / 2, (t + bt) / 2, r - l, bt - t], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of ltrb boxes: a (..., N, 4), b (..., M, 4) → (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter, min=1e-10)


def valid_boxes(gt_boxes: torch.Tensor) -> torch.Tensor:
    """Rows of positive area: a padded ground-truth row is all zeros."""
    return ((gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])) > 0


def last_writer(index: torch.Tensor, n: int) -> torch.Tensor:
    """For ``index`` (B, G) of targets in ``[0, n)``: (B, n), the highest
    ``g`` with ``index[:, g] == i`` at each ``i``, or -1 where none points.
    This is the update that ``zeros(n).at[index].set(values)`` leaves in place
    where indices repeat (JAX applies them in order on the CPU)."""
    g = torch.arange(index.shape[-1], device=index.device).expand_as(index)
    out = torch.full((*index.shape[:-1], n), -1, dtype=torch.long, device=index.device)
    return out.scatter_reduce(-1, index, g, reduce="amax", include_self=True)


def _force_matched(ious: torch.Tensor, valid: torch.Tensor):
    """Each ground truth's best box claims it (the last claim wins): whether
    a box is forced, and the ground truth that forced it (0 where none)."""
    best_box = torch.argmax(ious, dim=-2)                        # (B, G)
    writer = last_writer(best_box, ious.shape[-2])               # (B, D)
    has = writer >= 0
    w = writer.clamp(min=0)
    force = has & torch.gather(valid, -1, w)
    return force, torch.where(force, w, torch.zeros_like(w))


def encode_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   dboxes_ltrb: torch.Tensor, dboxes_xywh: torch.Tensor,
                   criteria: float = 0.5, scale_xy: float = 0.1, scale_wh: float = 0.2):
    """Match ground truth to default boxes and build regression targets.

    gt_boxes (B, G, 4) ltrb normalized (pad rows with zeros, label 0),
    gt_labels (B, G).  Returns (loc_target (B, D, 4) in scaled cxcywh-offset
    form, cls_target (B, D) int32)."""
    ious = box_iou(dboxes_ltrb, gt_boxes)                         # (B, D, G)
    valid = valid_boxes(gt_boxes)
    ious = torch.where(valid[..., None, :], ious, torch.full_like(ious, -1.0))

    best_gt_iou = torch.amax(ious, dim=-1)
    best_gt_idx = torch.argmax(ious, dim=-1)                      # the first maximum
    force, claimed_gt = _force_matched(ious, valid)

    matched = (best_gt_iou > criteria) | force
    gt_idx = torch.where(force, claimed_gt, best_gt_idx)

    labels = torch.gather(gt_labels.long(), -1, gt_idx)
    cls_target = torch.where(matched, labels, torch.zeros_like(labels))
    mb = cxcywh_from_ltrb(torch.gather(gt_boxes, -2, gt_idx[..., None].expand(*gt_idx.shape, 4)))
    db = dboxes_xywh
    loc = torch.stack([
        (mb[..., 0] - db[:, 0]) / db[:, 2] / scale_xy,
        (mb[..., 1] - db[:, 1]) / db[:, 3] / scale_xy,
        torch.log(torch.clamp(mb[..., 2], min=1e-8) / db[:, 2]) / scale_wh,
        torch.log(torch.clamp(mb[..., 3], min=1e-8) / db[:, 3]) / scale_wh,
    ], dim=-1)
    loc = torch.where(matched[..., None], loc, torch.zeros_like(loc))
    return loc, cls_target.to(torch.int32)


def decode_boxes(loc: torch.Tensor, dboxes_xywh: torch.Tensor,
                 scale_xy: float = 0.1, scale_wh: float = 0.2) -> torch.Tensor:
    """Inverse of :func:`encode_targets` → ltrb."""
    db = dboxes_xywh
    cx = loc[..., 0] * scale_xy * db[:, 2] + db[:, 0]
    cy = loc[..., 1] * scale_xy * db[:, 3] + db[:, 1]
    w = torch.exp(loc[..., 2] * scale_wh) * db[:, 2]
    h = torch.exp(loc[..., 3] * scale_wh) * db[:, 3]
    return ltrb_from_cxcywh(torch.stack([cx, cy, w, h], dim=-1))


def nms_numpy(boxes: np.ndarray, scores: np.ndarray,
              iou_threshold: float = 0.45, max_out: int = 200) -> np.ndarray:
    """Host-side greedy NMS over ltrb boxes → kept indices."""
    order = np.argsort(-scores)
    keep: List[int] = []
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    while len(order) and len(keep) < max_out:
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        lt = np.maximum(boxes[i, :2], boxes[rest, :2])
        rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / np.clip(areas[i] + areas[rest] - inter, 1e-10, None)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(loc_pred: torch.Tensor, cls_logits: torch.Tensor,
                  loc_target: torch.Tensor, cls_target: torch.Tensor,
                  neg_pos_ratio: int = 3, reduction: str = "mean") -> torch.Tensor:
    """SSD MultiBox loss with hard negative mining: smooth-L1 over positives
    + CE over the positives and the 3:1 hardest negatives, normalized by the
    positive count; an image without positives adds 0.  The mean over the
    images, or (``reduction="none"``) each image's loss: every term is an
    image's own, so data parallelism takes its share of the mean.

    Shapes: loc (B, D, 4), cls_logits (B, D, C), cls_target (B, D)."""
    pos = cls_target > 0
    num_pos = torch.sum(pos, dim=1)

    loc_loss = torch.sum(smooth_l1(loc_pred - loc_target).sum(-1) * pos, dim=1)

    ce = -F.log_softmax(cls_logits, dim=-1)
    ce_gt = torch.gather(ce, -1, cls_target.long()[..., None])[..., 0]

    # hard negative mining: rank the background CE among the negatives; the
    # sort is stable, as jnp.argsort is, so tied negatives rank by index
    con_neg = torch.where(pos, torch.zeros_like(ce_gt), ce_gt)
    order = torch.argsort(-con_neg, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    num_neg = torch.clamp(neg_pos_ratio * num_pos, 0, cls_target.shape[1] - 1)[:, None]
    neg = rank < num_neg

    cls_loss = torch.sum(ce_gt * (pos | neg), dim=1)
    total = loc_loss + cls_loss
    denom = torch.clamp(num_pos.to(total.dtype), min=1e-6)
    per_image = torch.where(num_pos > 0, total / denom, torch.zeros_like(total))
    return per_image if reduction == "none" else torch.mean(per_image)
