"""Mask R-CNN with static shapes (port of
``vqvae2_tpu/detection/mask_rcnn.py``): a ResNet trunk to layer3, a light FPN,
an RPN with a fixed top-K of proposals (no NMS in training), RoIAlign by
bilinear sampling, box and mask heads, and the target assignment and losses.

Layout as in the JAX package: images and features ``(B, H, W, C)``, boxes
normalized ltrb, ground truth padded to ``max_boxes`` rows with label 0.

What carries over exactly:

* :func:`roi_align` is the JAX package's, not torchvision's RoIAlign: one
  bilinear sample at each point of a ``linspace`` grid spanning the box
  (computed as ``jnp.linspace`` computes it), corner indices clipped to
  ``[0, size - 2]``, no averaging over sampling points.
* The FPN's top-down upsampling is ``jax.image.resize(..., "nearest")``,
  which samples at half-pixel centres: ``mode="nearest-exact"``.  torch's
  ``"nearest"`` picks other rows where the ratio is not 2 (38 -> 75: 19 of 75).
* ``jax.lax.top_k`` puts the lower index first among equal scores;
  :func:`decode_proposals` takes the first ``k`` of a stable descending sort,
  which keeps that order (``torch.topk`` does not promise one).
* The force-match scatter of :func:`rpn_targets` follows the JAX package's
  last-write order (``boxes.last_writer``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.detection import boxes as B
from vqvae2_tpu_torch.models.resnet import (CONFIGS, Conv2d, Dense, ResNetStem, _make_layer,
                                            expansion)


# ---------------------------------------------------------------------------
# Anchors
# ---------------------------------------------------------------------------

def generate_anchors(img_size: int, strides: Sequence[int] = (4, 8, 16),
                     sizes: Sequence[int] = (32, 64, 128),
                     ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """Multi-level anchor grid in normalized ltrb; (A, 4).  The default strides
    are the FPN levels' (p2/p3/p4 at 4x/8x/16x of the input)."""
    out = []
    for stride, size in zip(strides, sizes):
        feat = img_size // stride
        cy, cx = np.meshgrid(
            (np.arange(feat) + 0.5) * stride / img_size,
            (np.arange(feat) + 0.5) * stride / img_size, indexing="ij")
        for r in ratios:
            h = size * np.sqrt(r) / img_size
            w = size / np.sqrt(r) / img_size
            out.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2], axis=-1).reshape(-1, 4))
    return np.concatenate(out, axis=0).astype(np.float32)


# ---------------------------------------------------------------------------
# RoIAlign (batched bilinear sampling)
# ---------------------------------------------------------------------------

def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` along a new last axis, as JAX
    computes it in fp32: ``start * (1 - t) + stop * t`` with ``stop`` itself
    last, where ``t = i * (1 / (num - 1))`` (XLA divides by the constant as a
    multiply by its reciprocal).  ``t`` is made on the host, so the card and
    the CPU sample at the same points (PyTorch's CUDA division by a number
    is a reciprocal multiply, its CPU one a true division)."""
    t = np.arange(num - 1, dtype=np.float32) * (np.float32(1) / np.float32(num - 1))
    step = torch.from_numpy(t).to(device=start.device, dtype=start.dtype)
    body = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([body, stop[..., None]], dim=-1)


def sample_grid(boxes_ltrb: torch.Tensor, h: int, w: int, out_size: int):
    """The sampling grid of :func:`roi_align` for boxes (..., 4): corner rows
    ``y0`` and columns ``x0`` (..., out) and their weights ``wy``, ``wx``."""
    ys = _linspace(boxes_ltrb[..., 1], boxes_ltrb[..., 3], out_size) * (h - 1)
    xs = _linspace(boxes_ltrb[..., 0], boxes_ltrb[..., 2], out_size) * (w - 1)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2).long()
    x0 = torch.clamp(torch.floor(xs), 0, w - 2).long()
    wy = torch.clamp(ys - y0, 0.0, 1.0)
    wx = torch.clamp(xs - x0, 0.0, 1.0)
    return y0, x0, wy, wx


def bilinear(corners, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Blend the four corner samples (..., out, out, C) in the JAX package's
    order of operations; ``wy``/``wx`` are (..., out)."""
    f00, f01, f10, f11 = corners
    wy_ = wy[..., :, None, None]
    wx_ = wx[..., None, :, None]
    return (f00 * (1 - wy_) * (1 - wx_) + f01 * (1 - wy_) * wx_
            + f10 * wy_ * (1 - wx_) + f11 * wy_ * wx_)


def roi_align(feat: torch.Tensor, boxes_ltrb: torch.Tensor, out_size: int) -> torch.Tensor:
    """feat (B, H, W, C), boxes (B, N, 4) normalized ltrb → (B, N, out, out, C).

    The gradient flows to ``feat`` (a gather, whose backward sums the
    samples' weights into the feature map); the boxes take none."""
    b, h, w, c = feat.shape
    y0, x0, wy, wx = sample_grid(boxes_ltrb.detach(), h, w, out_size)
    flat = feat.reshape(b, h * w, c)
    bi = torch.arange(b, device=feat.device)[:, None, None, None]

    def at(dy: int, dx: int) -> torch.Tensor:
        idx = (y0 + dy)[..., :, None] * w + (x0 + dx)[..., None, :]    # (B, N, out, out)
        return flat[bi, idx]

    return bilinear((at(0, 0), at(0, 1), at(1, 0), at(1, 1)), wy.detach(), wx.detach())


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(x, (b, *hw, c), "nearest")`` on (B, H, W, C)."""
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode="nearest-exact").permute(0, 2, 3, 1)


class LightFPN(nn.Module):
    """Lateral 1x1 + top-down nearest + 3x3 smooth over (C2, C3, C4)."""

    def __init__(self, in_features: Sequence[int], channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c2, c3, c4 = in_features
        self.lat2 = Conv2d(c2, channels, 1, dtype=dtype)
        self.lat3 = Conv2d(c3, channels, 1, dtype=dtype)
        self.lat4 = Conv2d(c4, channels, 1, dtype=dtype)
        self.s2 = Conv2d(channels, channels, 3, padding=1, dtype=dtype)
        self.s3 = Conv2d(channels, channels, 3, padding=1, dtype=dtype)
        self.s4 = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, c2, c3, c4):
        p4 = self.lat4(c4)
        p3 = self.lat3(c3)
        p2 = self.lat2(c2)
        p3 = p3 + upsample_nearest(p4, p3.shape[1:3])
        p2 = p2 + upsample_nearest(p3, p2.shape[1:3])
        return self.s2(p2), self.s3(p3), self.s4(p4)


class RPNHead(nn.Module):
    """One 3x3 conv shared by the levels, then 1x1 objectness and deltas."""

    def __init__(self, channels: int = 128, num_anchors_per_loc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)
        self.obj = Conv2d(channels, num_anchors_per_loc, 1, dtype=dtype)
        self.reg = Conv2d(channels, num_anchors_per_loc * 4, 1, dtype=dtype)

    def forward(self, feats):
        objs, regs = [], []
        for f in feats:
            h = F.relu(self.conv(f))
            b = f.shape[0]
            objs.append(self.obj(h).reshape(b, -1))
            regs.append(self.reg(h).reshape(b, -1, 4))
        return torch.cat(objs, 1), torch.cat(regs, 1)


class BoxHead(nn.Module):
    """(N, 7, 7, C) → class logits (N, classes), deltas (N, 4)."""

    def __init__(self, num_classes: int, channels: int = 128, size: int = 7):
        super().__init__()
        self.fc0 = Dense(size * size * channels, 256)
        self.fc1 = Dense(256, 256)
        self.cls = Dense(256, num_classes)
        self.reg = Dense(256, 4)

    def forward(self, rois: torch.Tensor):
        h = rois.reshape(*rois.shape[:-3], -1)
        h = F.relu(self.fc0(h))
        h = F.relu(self.fc1(h))
        return self.cls(h), self.reg(h)


class MaskHead(nn.Module):
    """(N, 14, 14, C) → mask logits (N, 28, 28, classes)."""

    def __init__(self, num_classes: int, channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = Conv2d(channels, 128, 3, padding=1, dtype=dtype)
        self.conv1 = Conv2d(128, 128, 3, padding=1, dtype=dtype)
        self.up_conv = Conv2d(128, 128, 3, padding=1, dtype=dtype)
        self.mask_out = Conv2d(128, num_classes, 1, dtype=dtype)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv0(rois))
        h = F.relu(self.conv1(h))
        h = upsample_nearest(h, (h.shape[1] * 2, h.shape[2] * 2))
        h = F.relu(self.up_conv(h))
        return self.mask_out(h)


class MaskRCNN(nn.Module):
    """The backbone (stem, layer2, layer3), FPN and RPN, and the RoI heads.
    Holds the union of the JAX trainer's two ``init`` calls' variables."""

    def __init__(self, num_classes: int, img_size: int = 256, num_proposals: int = 64,
                 arch: str = "resnet18", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg, e = CONFIGS[arch], expansion(arch)
        self.num_classes, self.img_size, self.num_proposals = num_classes, img_size, num_proposals
        self.stem = ResNetStem(arch, dtype=dtype)
        self.layer2 = _make_layer(cfg["block"], 128, cfg["layers"][1], 2, 64 * e, dtype)
        self.layer3 = _make_layer(cfg["block"], 256, cfg["layers"][2], 2, 128 * e, dtype)
        self.fpn = LightFPN((64 * e, 128 * e, 256 * e), dtype=dtype)
        self.rpn = RPNHead(dtype=dtype)
        self.box_head = BoxHead(num_classes)
        self.mask_head = MaskHead(num_classes, dtype=dtype)

    def backbone(self, x: torch.Tensor):
        h = F.relu(self.stem(x))
        c2 = h
        for blk in self.layer2:
            h = blk(h)
        c3 = h
        for blk in self.layer3:
            h = blk(h)
        return self.fpn(c2, c3, h)

    def forward(self, images: torch.Tensor):
        """Returns (rpn_obj, rpn_reg, p2); the heads run on proposals through
        :meth:`roi_outputs`, so training can pick the RoIs."""
        p2, p3, p4 = self.backbone(images)
        rpn_obj, rpn_reg = self.rpn((p2, p3, p4))
        return rpn_obj, rpn_reg, p2

    def roi_outputs(self, p2: torch.Tensor, rois_ltrb: torch.Tensor):
        """rois (B, N, 4) → (cls (B, N, C), reg (B, N, 4), masks (B, N, 28, 28, C))."""
        b, n = rois_ltrb.shape[:2]
        cls, reg = self.box_head(roi_align(p2, rois_ltrb, 7))
        mask_feat = roi_align(p2, rois_ltrb, 14)
        masks = self.mask_head(mask_feat.reshape(b * n, *mask_feat.shape[2:]))
        return cls, reg, masks.reshape(b, n, *masks.shape[1:])


# ---------------------------------------------------------------------------
# Target assignment + losses (static shapes, batched over images)
# ---------------------------------------------------------------------------

def _deltas(mb: torch.Tensor, ref_xywh: torch.Tensor, wh_floor=None) -> torch.Tensor:
    w, h = ref_xywh[..., 2], ref_xywh[..., 3]
    if wh_floor is not None:
        w, h = torch.clamp(w, min=wh_floor), torch.clamp(h, min=wh_floor)
    return torch.stack([
        (mb[..., 0] - ref_xywh[..., 0]) / w,
        (mb[..., 1] - ref_xywh[..., 1]) / h,
        torch.log(torch.clamp(mb[..., 2], min=1e-6) / w),
        torch.log(torch.clamp(mb[..., 3], min=1e-6) / h),
    ], dim=-1)


def _gather_boxes(gt_boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(gt_boxes, -2, idx[..., None].expand(*idx.shape, 4))


def _masked_ious(rois: torch.Tensor, gt_boxes: torch.Tensor):
    ious = B.box_iou(rois, gt_boxes)
    valid = B.valid_boxes(gt_boxes)
    return torch.where(valid[..., None, :], ious, torch.full_like(ious, -1.0)), valid


def rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                pos_iou: float = 0.5, neg_iou: float = 0.3):
    """Per-anchor objectness target (1 pos / 0 neg / -1 ignore) (B, A) and
    box deltas (B, A, 4) clipped to ±4."""
    ious, valid = _masked_ious(anchors, gt_boxes)                  # (B, A, G)
    best_iou = torch.amax(ious, dim=-1)
    best_gt = torch.argmax(ious, dim=-1)
    force, _ = B._force_matched(ious, valid)

    one, zero, ignore = (torch.full_like(best_gt, v) for v in (1, 0, -1))
    obj = torch.where(best_iou >= pos_iou, one, torch.where(best_iou < neg_iou, zero, ignore))
    obj = torch.where(force, one, obj)
    deltas = _deltas(B.cxcywh_from_ltrb(_gather_boxes(gt_boxes, best_gt)),
                     B.cxcywh_from_ltrb(anchors))
    # a force-matched anchor far from its gt would give huge deltas
    return obj, torch.clamp(deltas, -4.0, 4.0)


def decode_proposals(anchors: torch.Tensor, rpn_obj: torch.Tensor, rpn_reg: torch.Tensor,
                     k: int):
    """The top-``k`` scored anchors a image, decoded to boxes clipped to
    [0, 1] (the static-shape stand-in for train-time NMS).  Returns (boxes
    (B, k, 4), scores (B, k)).

    ``jax.lax.top_k`` orders equal scores by index; the first ``k`` of a
    stable descending sort do too."""
    axywh = B.cxcywh_from_ltrb(anchors)
    score, idx = torch.sort(rpn_obj, dim=-1, descending=True, stable=True)
    score, idx = score[:, :k], idx[:, :k]
    a = axywh[idx]                                                 # (B, k, 4)
    r = torch.gather(rpn_reg, 1, idx[..., None].expand(*idx.shape, 4))
    cx = r[..., 0] * a[..., 2] + a[..., 0]
    cy = r[..., 1] * a[..., 3] + a[..., 1]
    w = torch.exp(torch.clamp(r[..., 2], -4, 4)) * a[..., 2]
    h = torch.exp(torch.clamp(r[..., 3], -4, 4)) * a[..., 3]
    boxes = B.ltrb_from_cxcywh(torch.stack([cx, cy, w, h], -1))
    return torch.clamp(boxes, 0.0, 1.0), score


def roi_targets(proposals: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                pos_iou: float = 0.5):
    """Per-proposal class target (0 = background) (B, N) int32, box deltas
    (B, N, 4) clipped to ±4, and the matched gt index (B, N)."""
    ious, _ = _masked_ious(proposals, gt_boxes)
    best_iou = torch.amax(ious, dim=-1)
    best_gt = torch.argmax(ious, dim=-1)
    labels = torch.gather(gt_labels.long(), -1, best_gt)
    labels = torch.where(best_iou >= pos_iou, labels, torch.zeros_like(labels))
    deltas = _deltas(B.cxcywh_from_ltrb(_gather_boxes(gt_boxes, best_gt)),
                     B.cxcywh_from_ltrb(proposals), wh_floor=1e-4)
    # thin proposals would give deltas in the hundreds through the 1e-4 floor
    return labels.to(torch.int32), torch.clamp(deltas, -4.0, 4.0), best_gt


def crop_gt_masks(gt_masks: torch.Tensor, gt_idx: torch.Tensor, proposals: torch.Tensor,
                  out: int = 28) -> torch.Tensor:
    """Each proposal's matched GT mask cropped to the proposal at (out, out):
    :func:`roi_align` of the mask as a float map, sampled straight from the
    ``uint8`` masks (B, G, H, W) by index.  Returns (B, N, out, out)."""
    b, _, h, w = gt_masks.shape
    y0, x0, wy, wx = sample_grid(proposals, h, w, out)
    flat = gt_masks.reshape(b, -1)
    base = (gt_idx * (h * w))[..., None, None]
    bi = torch.arange(b, device=gt_masks.device)[:, None, None, None]

    def at(dy: int, dx: int) -> torch.Tensor:
        idx = base + (y0 + dy)[..., :, None] * w + (x0 + dx)[..., None, :]
        return flat[bi, idx].to(torch.float32)[..., None]

    return bilinear((at(0, 0), at(0, 1), at(1, 0), at(1, 1)), wy, wx)[..., 0]


def _counts(*masks: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(jnp.sum(mask), 1.0)`` of each mask, over every rank's
    rows under a process group (one all-reduce, detached)."""
    sums = torch.stack([torch.sum(m) for m in masks]).detach()
    return torch.clamp(par.all_reduce(sums).to(torch.float32), min=1.0)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)


def mask_rcnn_loss(rpn_obj, rpn_reg, obj_t, delta_t, roi_cls, roi_reg, roi_labels,
                   roi_deltas, mask_logits, mask_targets) -> Tuple[torch.Tensor,
                                                                    Dict[str, torch.Tensor]]:
    """Combined RPN + RoI + mask losses (masked reductions over the whole
    batch), and each term.  Under a process group the batch is every rank's
    images: the counts that normalise the terms are summed over the ranks,
    and each value is this rank's share of the global one (the ranks' values
    sum to it)."""
    pos = obj_t == 1
    valid = obj_t >= 0
    roi_pos = roi_labels > 0
    n_valid, n_anchor_pos, n_pos, n_neg = _counts(valid, pos, roi_pos, ~roi_pos)
    obj_bce = sigmoid_bce(rpn_obj, pos.to(rpn_obj.dtype))
    rpn_cls_loss = torch.sum(obj_bce * valid) / n_valid
    rpn_reg_loss = (torch.sum(B.smooth_l1(rpn_reg - delta_t).sum(-1) * pos)
                    / n_anchor_pos)

    # Balanced RoI classification: with ~1-3 positives among 64+ RoIs a plain
    # mean collapses the classifier to background; the CE is reweighted to
    # the 1:3 positive:negative ratio torchvision's sampler keeps.
    ce = -torch.gather(F.log_softmax(roi_cls, dim=-1), -1, roi_labels.long()[..., None])[..., 0]
    roi_ce = 0.25 * torch.sum(ce * roi_pos) / n_pos + 0.75 * torch.sum(ce * ~roi_pos) / n_neg
    roi_reg_loss = (torch.sum(B.smooth_l1(roi_reg - roi_deltas).sum(-1) * roi_pos)
                    / n_pos)

    # mask BCE on the labelled class's channel of the positive RoIs
    cls_idx = roi_labels.long()[..., None, None, None].expand(*mask_logits.shape[:-1], 1)
    pred = torch.gather(mask_logits, -1, cls_idx)[..., 0]
    mask_bce = sigmoid_bce(pred, mask_targets)
    mask_loss = (torch.sum(mask_bce.mean(dim=(-1, -2)) * roi_pos)
                 / n_pos)

    total = rpn_cls_loss + rpn_reg_loss + roi_ce + roi_reg_loss + mask_loss
    return total, {"rpn_cls": rpn_cls_loss, "rpn_reg": rpn_reg_loss, "roi_cls": roi_ce,
                   "roi_reg": roi_reg_loss, "mask": mask_loss, "loss": total}
