"""SSD detection trainer and evaluator (port of
``vqvae2_tpu/train/detection.py``): SSD300 over COCO box annotations, the
MultiBox loss, SGD with momentum 0.9 after a linear warmup from ``lr / 100``
(``optax.sgd(linear_schedule(lr / 100, lr, warmup), momentum=0.9)``, warmup
``min(1000, total_steps // 10 + 1)`` updates), a stop on a non-finite loss,
and COCO-style AP with NMS.

One step: the forward in train mode (the batch norms move their running
statistics), target matching on the device, the loss, backward, the
schedule's rate into the optimizer, ``optimizer.step()``.  Evaluation runs
the eval-mode forward, box decoding and softmax on the device, then the
per-class NMS and the top ``max_det`` on the host.

Data parallel (``parallel``): a step takes the global batch and each rank its
images (``shard_batch``); the batch norms take the global batch's moments,
the rank backpropagates its share of the mean over the images, and the
gradients are summed over the ranks, so a world of N ranks takes the
single-process step.  Target matching stays per image.  ``main`` runs
``train`` through ``parallel.launch``; logs and evaluation (NMS and AP on the
host, the model in eval mode, no collective) come from the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.detection --synthetic --steps 10``.
The device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import math
import tempfile
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.detection import boxes as B
from vqvae2_tpu_torch.detection.coco_eval import evaluate_detections
from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco
from vqvae2_tpu_torch.detection.ssd import SSD300
from vqvae2_tpu_torch.train.vqvae import TrainState
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.metrics import CsvLogger

DetState = TrainState


def make_optimizer(lr: float, total_steps: int) -> schedules.SGDSchedule:
    warmup = min(1000, total_steps // 10 + 1)
    return schedules.SGDSchedule(schedules.linear_schedule(lr / 100, lr, warmup),
                                 momentum=0.9, nesterov=False)


def create_state(model: SSD300, tx: schedules.SGDSchedule) -> DetState:
    return DetState(step=0, model=model.train(), optimizer=tx.build(model.parameters()))


def make_train_step(model: SSD300, tx: schedules.SGDSchedule, dboxes: np.ndarray):
    """Returns ``train_step(state, imgs, gt_boxes, gt_labels) -> (state,
    loss)``: the global batch (numpy arrays or tensors, host or device), of
    which this rank takes its images; the loss is the global batch's, a
    0-dim tensor."""
    device = next(model.parameters()).device
    db = torch.from_numpy(np.asarray(dboxes, np.float32)).to(device)
    db_ltrb = B.ltrb_from_cxcywh(db)

    def train_step(state: DetState, imgs, gt_boxes, gt_labels):
        rows = imgs.shape[0]
        imgs, gt_boxes, gt_labels = par.local_batch((imgs, gt_boxes, gt_labels), device)
        state.optimizer.zero_grad(set_to_none=True)
        loc, conf = model(imgs)
        loc_t, cls_t = B.encode_targets(gt_boxes, gt_labels, db_ltrb, db)
        loss = par.share_mean(B.multibox_loss(loc, conf, loc_t, cls_t, reduction="none"), rows)
        loss.backward()
        par.all_reduce_grads(model.parameters())
        loss = par.all_reduce(loss.detach())
        schedules.fill_missing_grads(state.optimizer)
        tx.apply(state.optimizer, state.step)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return train_step


def evaluate(model: SSD300, state: DetState, dataset, dboxes: np.ndarray,
             batch_size: int = 8, score_thresh: float = 0.05, nms_iou: float = 0.45,
             max_det: int = 100, viz_dir: str = "", viz_max: int = 16) -> Dict[str, float]:
    """NMS + COCO AP over ``dataset``; with ``viz_dir``, annotated [prediction
    | GT] PNGs of the first ``viz_max`` images."""
    device = next(model.parameters()).device
    db = torch.from_numpy(np.asarray(dboxes, np.float32)).to(device)
    was_training = model.training
    model.eval()
    preds, gts = [], []
    try:
        for imgs, gt_boxes, gt_labels, img_ids in dataset.batches(
                batch_size, shuffle=False, drop_last=False):
            with torch.no_grad():
                loc, conf = model(torch.from_numpy(imgs).to(device))
                boxes = B.decode_boxes(loc, db).cpu().numpy()
                probs = F.softmax(conf, dim=-1).cpu().numpy()
            for bi, img_id in enumerate(img_ids):
                out_b, out_s, out_l = [], [], []
                for c in range(1, probs.shape[-1]):
                    sc = probs[bi, :, c]
                    sel = sc > score_thresh
                    if not sel.any():
                        continue
                    keep = B.nms_numpy(boxes[bi][sel], sc[sel], nms_iou)
                    out_b.append(boxes[bi][sel][keep])
                    out_s.append(sc[sel][keep])
                    out_l.append(np.full(len(keep), c))
                if out_b:
                    ob = np.concatenate(out_b)
                    os_ = np.concatenate(out_s)
                    ol = np.concatenate(out_l)
                    top = np.argsort(-os_)[:max_det]
                    preds.append((img_id, ob[top], os_[top], ol[top]))
                else:
                    preds.append((img_id, np.zeros((0, 4)), np.zeros(0), np.zeros(0, np.int64)))
                valid = gt_labels[bi] > 0
                gts.append((img_id, gt_boxes[bi][valid], gt_labels[bi][valid]))
                if viz_dir and len(preds) <= viz_max:
                    from vqvae2_tpu_torch.detection.visualize import save_detections

                    _, pb, ps, pl = preds[-1]
                    save_detections(
                        f"{viz_dir}/det_{img_id:05d}.png", imgs[bi], pb, pl, ps,
                        gt_boxes=gt_boxes[bi][valid], gt_labels=gt_labels[bi][valid],
                        class_names=getattr(dataset, "class_names", None), score_thresh=0.3)
    finally:
        model.train(was_training)
    return evaluate_detections(preds, gts)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = CocoDetectionDataset(args.img_dir, args.ann_file, size=args.size)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    if args.size != 300:
        raise SystemExit("SSD300's default-box grid is fixed to 300px input; use --size 300")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = SSD300(num_classes=dataset.num_classes, arch=args.arch).to(device)
    if args.pretrained:
        # the backbone from a torchvision resnet; the heads stay fresh
        from vqvae2_tpu_torch.models.resnet import import_torchvision_resnet

        n = import_torchvision_resnet(model, args.pretrained)
        if par.is_primary():
            print(f"imported {n} backbone tensors from {args.pretrained}", flush=True)
    tx = make_optimizer(args.lr, total_steps)
    dboxes = B.default_boxes_ssd300(fig_size=args.size)
    state = create_state(model, tx)
    par.replicate(state.model)
    step_fn = make_train_step(model, tx, dboxes)

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    map_csv = CsvLogger(args.map_csv if primary else "")
    n_done, t0 = 0, time.perf_counter()
    loss = float("nan")
    while n_done < total_steps:
        for imgs, gt_boxes, gt_labels, _ in dataset.batches(args.batch_size,
                                                             seed=args.seed + n_done):
            state, loss_dev = step_fn(state, imgs, gt_boxes, gt_labels)
            n_done += 1
            loss = float(loss_dev)          # the global batch's: every rank stops alike
            if not math.isfinite(loss):
                raise SystemExit(f"Loss is {loss}, stopping training")
            if n_done % args.log_every == 0 and primary:
                rate = n_done * args.batch_size / (time.perf_counter() - t0)
                print(f"step {n_done}/{total_steps} loss {loss:.4f} ({rate:.1f} img/s)",
                      flush=True)
                csv.log(n_done, {"loss": loss, "img_per_s": rate})
            if args.eval_every and n_done % args.eval_every == 0 and primary:
                ev = evaluate(model, state, dataset, dboxes, batch_size=args.batch_size)
                map_csv.log(n_done, {k: v for k, v in ev.items()
                                     if not k.startswith("AP50_class")})
                print(f"step {n_done}: mAP {ev.get('mAP', float('nan')):.4f} "
                      f"AP50 {ev.get('AP50', float('nan')):.4f}", flush=True)
            if n_done >= total_steps:
                break

    metrics = {"loss": loss}
    if args.eval and primary:
        metrics.update(evaluate(model, state, dataset, dboxes, batch_size=args.batch_size,
                                viz_dir=args.viz_dir))
        print({k: round(v, 4) for k, v in metrics.items()
               if not k.startswith("AP50_class")}, flush=True)
    return metrics


def build_argparser():
    p = argparse.ArgumentParser(description="SSD detection trainer (PyTorch/CUDA)")
    p.add_argument("--img_dir", type=str, default="")
    p.add_argument("--ann_file", type=str, default="")
    p.add_argument("--size", type=int, default=300)
    p.add_argument("--epoch", type=int, default=26)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--pretrained", type=str, default="",
                   help="torchvision resnet state_dict (.pt) for the backbone")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--viz_dir", type=str, default="",
                   help="dump annotated prediction PNGs during --eval")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=0,
                   help="run COCO AP evaluation every N steps")
    p.add_argument("--map_csv", type=str, default="",
                   help="append per-evaluation AP rows to this CSV")
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def run_synthetic(train_fn, args, **synthetic):
    """``train_fn(args)`` on ``--img_dir``/``--ann_file``, or on a synthetic
    COCO set at ``--size`` written to a temporary directory with
    ``--synthetic``, through ``parallel.launch``.  The device is resolved
    first: without it nothing is written."""
    resolve_device(args.device)
    if not args.synthetic:
        return par.launch(train_fn, args, device=args.device)
    return par.launch(_on_synthetic_coco, train_fn, args, synthetic, device=args.device)


def _on_synthetic_coco(train_fn, args, synthetic):
    """``train_fn(args)`` on a synthetic COCO set in a temporary directory
    (each rank writes the same set from the same seed)."""
    with tempfile.TemporaryDirectory(prefix="coco_syn_") as tmp:
        args.img_dir, args.ann_file = make_synthetic_coco(tmp, size=args.size, **synthetic)
        return train_fn(args)


def main(argv=None):
    return run_synthetic(train, build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
