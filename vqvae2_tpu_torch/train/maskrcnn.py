"""Mask R-CNN trainer (port of ``vqvae2_tpu/train/maskrcnn.py``): COCO boxes
and masks, Adam.

One step: the backbone, FPN and RPN forward in train mode, anchor matching,
the top-K proposals decoded and detached, the ground-truth boxes appended as
extra RoIs (K + ``max_boxes`` RoIs an image: before the RPN warms up every
proposal is background, and without them the heads collapse to it), RoI and
mask targets, the heads on the RoIs, the five-term loss, Adam.

Evaluation runs the eval-mode forward, proposals, heads, box deltas, softmax
and mask sigmoid on the device, then on the host: NMS over each RoI's best
class, box AP, mask AP of the pasted masks, and the mean mask IoU of the
detections that overlap a ground truth.  A 28x28 mask is pasted into its box
by bilinear resizing with half-pixel centres (``F.interpolate(...,
align_corners=False)``, what ``cv2.resize`` computes).

Data parallel (``parallel``): a step takes the global batch and each rank its
images (``shard_batch``); the batch norms take the global batch's moments,
the loss's counts (valid and positive anchors, positive and negative RoIs)
are summed over the ranks, and the gradients too, so a world of N ranks takes
the single-process step.  Proposals, RoI targets and mask crops stay per
image.  ``main`` runs ``train`` through ``parallel.launch``; logs and
evaluation come from the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.maskrcnn --synthetic --steps 10``
(``--size 64 --anchor_sizes 8,16,32`` for a small run).  The device defaults
to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.detection import boxes as B
from vqvae2_tpu_torch.detection import mask_rcnn as M
from vqvae2_tpu_torch.detection.coco_eval import evaluate_detections, evaluate_segmentations
from vqvae2_tpu_torch.detection.data import CocoDetectionDataset
from vqvae2_tpu_torch.train.detection import run_synthetic
from vqvae2_tpu_torch.train.vqvae import TrainState
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.metrics import CsvLogger

MRState = TrainState


def create_state(model: M.MaskRCNN, tx: schedules.AdamSchedule) -> MRState:
    return MRState(step=0, model=model.train(), optimizer=tx.build(model.parameters()))


def make_train_step(model: M.MaskRCNN, tx: schedules.AdamSchedule, anchors: np.ndarray):
    """Returns ``train_step(state, imgs, gt_boxes, gt_labels, gt_masks) ->
    (state, metrics)``: the global batch (numpy arrays or tensors, host or
    device), of which this rank takes its images; the metrics are the global
    batch's, 0-dim tensors."""
    device = next(model.parameters()).device
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)

    def train_step(state: MRState, imgs, gt_boxes, gt_labels, gt_masks):
        imgs, gt_boxes, gt_labels, gt_masks = par.local_batch(
            (imgs, gt_boxes, gt_labels, gt_masks), device)
        state.optimizer.zero_grad(set_to_none=True)
        rpn_obj, rpn_reg, p2 = model(imgs)
        obj_t, delta_t = M.rpn_targets(anchors_t, gt_boxes, gt_labels)
        with torch.no_grad():
            proposals, _ = M.decode_proposals(anchors_t, rpn_obj, rpn_reg, model.num_proposals)
            # the ground truth as extra RoIs; a padded row is degenerate, so
            # its IoU is 0 and it is labelled background
            proposals = torch.cat([proposals, gt_boxes], dim=1)
            roi_labels, roi_deltas, gt_idx = M.roi_targets(proposals, gt_boxes, gt_labels)
            mask_t = M.crop_gt_masks(gt_masks, gt_idx, proposals)
        roi_cls, roi_reg, mask_logits = model.roi_outputs(p2, proposals)
        total, metrics = M.mask_rcnn_loss(rpn_obj, rpn_reg, obj_t, delta_t, roi_cls, roi_reg,
                                          roi_labels, roi_deltas, mask_logits, mask_t)
        total.backward()
        par.all_reduce_grads(model.parameters())
        schedules.fill_missing_grads(state.optimizer)
        tx.apply(state.optimizer, state.step)
        state.optimizer.step()
        state.step += 1
        return state, par.global_metrics(metrics)

    return train_step


def eval_forward(model: M.MaskRCNN, anchors: torch.Tensor, imgs: torch.Tensor):
    """Boxes (B, K, 4) clipped to [0, 1], class probabilities (B, K, C) and
    mask probabilities (B, K, 28, 28, C) of the eval-mode forward."""
    rpn_obj, rpn_reg, p2 = model(imgs)
    proposals, _ = M.decode_proposals(anchors, rpn_obj, rpn_reg, model.num_proposals)
    roi_cls, roi_reg, mask_logits = model.roi_outputs(p2, proposals)
    pxywh = B.cxcywh_from_ltrb(proposals)
    cx = roi_reg[..., 0] * pxywh[..., 2] + pxywh[..., 0]
    cy = roi_reg[..., 1] * pxywh[..., 3] + pxywh[..., 1]
    w = torch.exp(torch.clamp(roi_reg[..., 2], -4, 4)) * pxywh[..., 2]
    h = torch.exp(torch.clamp(roi_reg[..., 3], -4, 4)) * pxywh[..., 3]
    boxes = B.ltrb_from_cxcywh(torch.stack([cx, cy, w, h], -1))
    return torch.clamp(boxes, 0, 1), F.softmax(roi_cls, dim=-1), torch.sigmoid(mask_logits)


def evaluate_instances(model: M.MaskRCNN, state: MRState, dataset, anchors: np.ndarray,
                       batch_size: int = 4, score_thresh: float = 0.05, nms_iou: float = 0.5,
                       mask_thresh: float = 0.5, viz_dir: str = "",
                       viz_max: int = 16) -> Dict[str, float]:
    """Box AP, mask AP (pycocotools' ``segm`` semantics) and the mean mask
    IoU of matched detections over ``dataset``."""
    device = next(model.parameters()).device
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)
    was_training = model.training
    model.eval()
    preds, gts, mask_ious = [], [], []
    seg_preds, seg_gts = [], []
    try:
        for imgs, gt_boxes, gt_labels, img_ids, gt_masks in dataset.batches(
                batch_size, shuffle=False, drop_last=False, with_masks=True):
            with torch.no_grad():
                out = eval_forward(model, anchors_t, torch.from_numpy(imgs).to(device))
            boxes, probs, masks = (t.cpu().numpy() for t in out)
            size = imgs.shape[1]
            for bi, img_id in enumerate(img_ids):
                cls = probs[bi, :, 1:]  # drop background
                best_c = cls.argmax(-1) + 1
                best_s = cls.max(-1)
                sel = best_s > score_thresh
                valid = gt_labels[bi] > 0
                g_boxes = gt_boxes[bi][valid] * size
                g_masks = gt_masks[bi][valid] > 0.5
                if sel.any():
                    keep = B.nms_numpy(boxes[bi][sel], best_s[sel], nms_iou)
                    kb = boxes[bi][sel][keep]
                    ks = best_s[sel][keep]
                    kc = best_c[sel][keep]
                    km = masks[bi][sel][keep]
                    preds.append((img_id, kb * size, ks, kc))
                    pasted = np.stack([_paste_mask(km[d, :, :, kc[d]], kb[d], size, mask_thresh)
                                       for d in range(len(kb))])
                    seg_preds.append((img_id, pasted, ks, kc))
                    # mean mask IoU against the best box-overlapping GT
                    for d in range(len(kb)):
                        if len(g_boxes) == 0:
                            continue
                        ious = _box_iou_np(kb[d] * size, g_boxes)
                        gi = int(ious.argmax())
                        if ious[gi] < 0.3:
                            continue
                        gm = g_masks[gi]
                        inter = np.logical_and(pasted[d], gm).sum()
                        union = np.logical_or(pasted[d], gm).sum()
                        if union:
                            mask_ious.append(inter / union)
                else:
                    preds.append((img_id, np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)))
                    seg_preds.append((img_id, np.zeros((0, size, size), bool), np.zeros(0),
                                      np.zeros(0, np.int64)))
                gts.append((img_id, g_boxes, gt_labels[bi][valid]))
                seg_gts.append((img_id, g_masks, gt_labels[bi][valid]))
                if viz_dir and len(preds) <= viz_max:
                    from vqvae2_tpu_torch.detection.visualize import save_detections

                    _, pb, ps, pc = preds[-1]
                    save_detections(
                        f"{viz_dir}/inst_{img_id:05d}.png", imgs[bi], pb, pc, ps,
                        masks=seg_preds[-1][1], gt_boxes=g_boxes, gt_labels=gt_labels[bi][valid],
                        class_names=getattr(dataset, "class_names", None), score_thresh=0.3)
    finally:
        model.train(was_training)
    out = evaluate_detections(preds, gts)
    seg = evaluate_segmentations(seg_preds, seg_gts)
    out["mask_mAP"] = seg["mAP"]
    out["mask_AP50"] = seg["AP50"]
    out["mask_AP75"] = seg["AP75"]
    out["mask_mIoU"] = float(np.mean(mask_ious)) if mask_ious else 0.0
    return out


def _box_iou_np(box, boxes):
    lt = np.maximum(box[:2], boxes[:, :2])
    rb = np.minimum(box[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.clip(a + b - inter, 1e-10, None)


def _paste_mask(mask28: np.ndarray, box: np.ndarray, size: int, thresh: float) -> np.ndarray:
    """Resize a 28x28 mask into its box on a (size, size) canvas: bilinear
    with half-pixel centres, as ``cv2.resize`` does."""
    out = np.zeros((size, size), bool)
    x0, y0, x1, y1 = (np.clip(box, 0, 1) * size).astype(int)
    if x1 <= x0 or y1 <= y0:
        return out
    m = torch.from_numpy(np.ascontiguousarray(mask28, np.float32))[None, None]
    m = F.interpolate(m, size=(int(y1 - y0), int(x1 - x0)), mode="bilinear",
                      align_corners=False)[0, 0].numpy()
    out[y0:y1, x0:x1] = m > thresh
    return out


def build_model(args, num_classes: int, device) -> M.MaskRCNN:
    """``MaskRCNN`` with weights drawn from ``--seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return M.MaskRCNN(num_classes=num_classes, img_size=args.size,
                          num_proposals=args.num_proposals, arch=args.arch).to(device)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = CocoDetectionDataset(args.img_dir, args.ann_file, size=args.size,
                                   with_masks=True, max_boxes=args.max_boxes)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    model = build_model(args, dataset.num_classes, device)
    sizes = tuple(int(s) for s in args.anchor_sizes.split(","))
    anchors = M.generate_anchors(args.size, sizes=sizes)
    tx = schedules.adam(args.lr)
    if args.pretrained:
        # the torchvision body with fresh heads
        from vqvae2_tpu_torch.models.resnet import import_torchvision_resnet

        n = import_torchvision_resnet(model, args.pretrained)
        if par.is_primary():
            print(f"imported {n} backbone tensors from {args.pretrained}", flush=True)
    state = create_state(model, tx)
    par.replicate(state.model)
    step_fn = make_train_step(model, tx, anchors)

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    map_csv = CsvLogger(args.map_csv if primary else "")
    n_done, t0, m = 0, time.perf_counter(), {}
    while n_done < total_steps:
        for imgs, gt_boxes, gt_labels, _, gt_masks in dataset.batches(
                args.batch_size, seed=args.seed + n_done, with_masks=True):
            state, metrics = step_fn(state, imgs, gt_boxes, gt_labels, gt_masks)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if not math.isfinite(m["loss"]):
                    raise SystemExit(f"Loss is {m['loss']}, stopping")
                if primary:
                    rate = n_done * args.batch_size / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} loss {m['loss']:.3f} "
                          f"rpn {m['rpn_cls']:.3f}/{m['rpn_reg']:.3f} "
                          f"roi {m['roi_cls']:.3f}/{m['roi_reg']:.3f} "
                          f"mask {m['mask']:.3f} ({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if args.eval_every and n_done % args.eval_every == 0 and primary:
                ev = evaluate_instances(model, state, dataset, anchors,
                                        batch_size=args.batch_size)
                row = {k: float(v) for k, v in ev.items() if not k.startswith("AP50_class")}
                map_csv.log(n_done, row)
                print(f"step {n_done}: bbox mAP {row.get('mAP', float('nan')):.4f} mask mAP "
                      f"{row.get('mask_mAP', float('nan')):.4f}", flush=True)
            if n_done >= total_steps:
                break

    if args.eval and primary:
        m.update(evaluate_instances(model, state, dataset, anchors, batch_size=args.batch_size,
                                    viz_dir=args.viz_dir))
        print({k: round(float(v), 4) for k, v in m.items()
               if not k.startswith("AP50_class")}, flush=True)
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="Mask R-CNN trainer (PyTorch/CUDA)")
    p.add_argument("--img_dir", type=str, default="")
    p.add_argument("--ann_file", type=str, default="")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--epoch", type=int, default=20)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_proposals", type=int, default=64)
    p.add_argument("--max_boxes", type=int, default=64,
                   help="GT pad slots per image; also the number of GT RoIs "
                        "injected into the head batch — set near the true "
                        "max object count to keep the RoI batch lean")
    p.add_argument("--anchor_sizes", type=str, default="32,64,128",
                   help="comma-separated anchor sizes in pixels, one per FPN "
                        "level — scale down with --size (at 64px the default "
                        "32/64/128 anchors dwarf every object)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--pretrained", type=str, default="",
                   help="torchvision resnet state_dict (.pt) for the backbone")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--viz_dir", type=str, default="",
                   help="dump annotated [pred | GT] PNGs during --eval")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=0,
                   help="run bbox+segm AP evaluation every N steps")
    p.add_argument("--map_csv", type=str, default="",
                   help="append per-evaluation AP rows to this CSV")
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    return run_synthetic(train, build_argparser().parse_args(argv), with_masks=True)


if __name__ == "__main__":
    main()
