"""Cross-modal ReID + part-parsing trainer (port of ``vqvae2_tpu/train/reid.py``).

The loss is the JAX package's, term for term: the gated parsing criterion
(samples whose parts cover less than 15 % of the pixels are masked to the
ignore label), part-wise InfoNCE over three rearrangements, per-part and
concatenated-part CE, the identity CE, cross-modal batch-hard triplets over the
(color, thermal, gray) splits, and ten times the color-gray feature MSE.

The optimizer is Nesterov SGD (momentum 0.9, weight decay 5e-4 on every
parameter) in two groups: the top-level ``bottleneck`` and ``classifier`` at
the full learning rate, everything else (``classifierP``, ``clsP_*``, ``pd``
included) at 0.01 of it, both following MultiStepLR at epochs 20, 40, 60 and
100 by the number of updates made before the step.  ``torch.optim.SGD(nesterov
=True, weight_decay=5e-4)`` makes the update of optax's ``add_decayed_weights``
then ``sgd``.

The parsing head's dropout is drawn from a ``torch.Generator`` made anew each
step from ``--seed`` and the step count (``train/pixelsnail.py::
step_generator``).  On the card the thirteen in-place ABNs of each forward run
the hand-written forward kernel, and their backward the hand-written backward
kernels.

Data parallel (``parallel``): a step takes the global P×K batch and each rank
its rows of each modality (``shard_batch``, each microbatch's under
``--grad_accum``), so the model's forward holds ``[rgb_r; ir_r; gray_r]``.
The batch norms and ABNs take the global batch's moments, the dropout draws
the global batch's mask and keeps this rank's rows, the parsing criterion
normalises by global counts and sorts the global pixels for the Lovasz term,
and the terms that pair rows (the triplets, the part InfoNCE over the
regrouped identities) run on the global rows (``gather_batch``), so a world
of N ranks takes the single-process step.  ``main`` runs ``train`` through
``parallel.launch``; logs, samples, validation and checkpoint files come from
the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.reid --synthetic [flags]``.  The device
defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import losses as L
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData
from vqvae2_tpu_torch.part import criterion as C
from vqvae2_tpu_torch.models.pixelsnail import batch_rows
from vqvae2_tpu_torch.part.part_model import EmbedNet2, _resize
from vqvae2_tpu_torch.train.pixelsnail import step_generator
from vqvae2_tpu_torch.train.vqvae import TrainState
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.metrics import CsvLogger
from vqvae2_tpu_torch.utils.schedules import multi_step_lr

IMG_H, IMG_W = 288, 144
FULL_LR_MODULES = ("bottleneck", "classifier")


def param_group(name: str) -> str:
    """``"cls"`` for the parameters of the top-level ``bottleneck`` and
    ``classifier``, ``"base"`` for every other."""
    return "cls" if name.split(".")[0] in FULL_LR_MODULES else "base"


class MultiStepSGD:
    """Nesterov SGD whose two groups follow ``lr_f * scale *
    multi_step_lr(step)``; :meth:`apply` writes the values for ``step`` into
    the groups and must run before each ``optimizer.step()``."""

    SCALES = {"base": 0.01, "cls": 1.0}

    def __init__(self, lr_f: float, steps_per_epoch: int):
        self.lr_f = lr_f
        self.schedule = multi_step_lr(1.0, [m * steps_per_epoch for m in (20, 40, 60, 100)])

    def build(self, model: torch.nn.Module) -> torch.optim.SGD:
        groups: Dict[str, list] = {"base": [], "cls": []}
        for name, p in model.named_parameters():
            groups[param_group(name)].append(p)
        return torch.optim.SGD(
            [{"params": groups[g], "group": g} for g in ("base", "cls") if groups[g]],
            lr=self.lr_f, momentum=0.9, nesterov=True, weight_decay=5e-4)

    def lr(self, group: str, step: int) -> float:
        return self.lr_f * self.SCALES[group] * self.schedule(step)

    def apply(self, optimizer: torch.optim.Optimizer, step: int) -> None:
        for group in optimizer.param_groups:
            group["lr"] = self.lr(group["group"], step)


def make_optimizer(lr_f: float, steps_per_epoch: int) -> MultiStepSGD:
    return MultiStepSGD(lr_f, steps_per_epoch)


def create_state(model: EmbedNet2, tx: MultiStepSGD) -> TrainState:
    return TrainState(step=0, model=model.train(), optimizer=tx.build(model))


def make_loss_fn(model: EmbedNet2, num_pos: int, batch_ids: int, img_hw=(IMG_H, IMG_W)):
    """The full ReID + part-parsing objective as ``loss_fn(batch, generator,
    rows=None) -> (objective, metrics)``: ``batch`` holds ``rgb``, ``ir``,
    ``gray`` ``(B, H, W, 3)``, ``label`` ``(B,)`` and ``part1``, ``part2``
    ``(B, H, W)`` on the model's device: this rank's rows of a global batch
    of ``rows`` (all of it without a group).  ``objective`` is what this rank
    backpropagates: its share of the terms per row and of the pixel losses,
    and the terms that pair rows whole, on the global rows.  The metrics are
    the global batch's, 0-dim tensors."""
    n_part = model.part_num - 1

    def loss_fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                rows: Optional[int] = None):
        labels1 = batch["label"].to(torch.int64)
        rows = labels1.shape[0] if rows is None else rows
        start = par.shard_rows(rows)[0]
        with batch_rows(start, rows, groups=3):
            out = model(xRGB=batch["rgb"], xIR=batch["ir"], xZ=batch["gray"], modal=0,
                        generator=generator)
        # bf16 compute stops at the model's boundary: every loss runs in fp32
        out = _widened(out)
        (feat, score, part_preds, _, parts_feat_x3, parts_feat, part_masks, parts_score,
         feats_p, score_p) = out

        labels = torch.cat([labels1, labels1, labels1])
        part_labels = torch.cat([batch["part1"], batch["part2"], batch["part1"]]).to(torch.int64)

        # samples whose parts cover < 15 % of the pixels: every label ignored
        coverage = torch.sum(part_labels != 0, dim=(1, 2))
        good = (coverage > int(img_hw[0] * img_hw[1] * 0.15))[:, None, None]
        ignore = torch.full_like(part_labels, C.IGNORE)
        gated = torch.where(good, part_labels, ignore)
        edges = torch.where(good, C.generate_edge(gated).to(torch.int64), ignore)
        (parsing, fusion), (edge_pred,) = part_preds[0], part_preds[1]
        part_loss = C.criterion_all([parsing, fusion], [edge_pred], gated, edges, groups=3,
                                    rows=rows)

        # the terms that pair rows, on the global rows in the global order
        gather = lambda t: par.gather_batch(t, rows, groups=3)        # noqa: E731
        feat_all, labels_all = gather(feat), par.gather_batch(labels1, rows)
        m = 3

        def regroup(x):  # '(m n p) ... -> n (p m) ...'
            rest = x.shape[1:]
            return (x.reshape(m, batch_ids, num_pos, *rest)
                    .permute(1, 2, 0, *range(3, 3 + len(rest)))
                    .reshape(batch_ids, num_pos * m, *rest))

        # part-wise InfoNCE over three rearrangements
        f_p = regroup(gather(feats_p))
        f2 = regroup(gather(parts_feat))
        x3 = gather(parts_feat_x3)
        cont2 = sum(C.contrastive_loss(f2[i]) for i in range(batch_ids)) / batch_ids
        cont3 = C.contrastive_loss(f_p.permute(1, 0, 2))
        unsup_part = C.contrastive_loss(x3.reshape(x3.shape[0], n_part, -1)) + cont2 + cont3

        cf, tf, gf = torch.chunk(feat_all, 3, dim=0)
        cl = labels_all
        loss_tri = (L.cross_triplet_loss(cf, tf, gf, cl, cl, cl)
                    + L.cross_triplet_loss(tf, gf, cf, cl, cl, cl)
                    + L.cross_triplet_loss(gf, cf, tf, cl, cl, cl)) / 3

        # the terms per row: this rank's share of the global means
        def ce(logits, target):
            return par.share_mean(F.cross_entropy(logits, target, reduction="none"), 3 * rows)

        loss_id_parts = sum(ce(ps, labels) / n_part for ps in parts_score) + ce(score_p, labels)
        loss_id_real = ce(score, labels)
        acc = par.share_mean((torch.argmax(score, dim=-1) == labels).to(torch.float32),
                             3 * rows)
        cf_own, _, gf_own = torch.chunk(feat, 3, dim=0)
        loss_c2g = 10.0 * par.share_mean(torch.square(cf_own - gf_own), rows)

        shares = loss_id_real + part_loss + loss_id_parts + loss_c2g
        metrics = par.global_metrics(
            {"loss": shares, "id": loss_id_real, "part": part_loss, "id_parts": loss_id_parts,
             "c2g": loss_c2g, "acc": acc},
            {"loss": loss_tri + unsup_part, "tri": loss_tri, "unsup": unsup_part})
        return shares + loss_tri + unsup_part, metrics

    return loss_fn


def _widened(tree):
    """Every tensor of a nested tuple or list of model outputs in fp32."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_widened(t) for t in tree)
    return tree.to(torch.float32) if isinstance(tree, torch.Tensor) else tree


def make_train_step(model: EmbedNet2, tx: MultiStepSGD, num_pos: int, batch_ids: int,
                    img_hw=(IMG_H, IMG_W), grad_accum: int = 1, seed: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is the global batch (numpy arrays or tensors, on the host or
    the device); under a process group this rank takes its rows of it and
    moves them to the model's device.  ``grad_accum > 1`` takes a list of
    that many P×K-structured microbatches: their gradients are summed and
    averaged, one SGD update follows, the batch-norm statistics advance
    through them in order and the metrics are their means.  The gradients
    are summed over the ranks before the update.  A step's dropout comes from
    ``step_generator(seed, state.step)``."""
    loss_fn = make_loss_fn(model, num_pos, batch_ids, img_hw)
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch):
        gen = step_generator(seed, state.step, device)
        state.optimizer.zero_grad(set_to_none=True)
        micro = [batch] if grad_accum == 1 else list(batch)
        if len(micro) != grad_accum:
            raise ValueError(f"expected {grad_accum} microbatches, got {len(micro)}")
        stacked = []
        for b in micro:
            rows = b["label"].shape[0]
            objective, metrics = loss_fn(par.local_batch(b, device), gen, rows)
            objective.backward()           # sums the microbatches' gradients
            stacked.append(metrics)
        par.all_reduce_grads(model.parameters())
        if grad_accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        metrics = {k: torch.stack([m[k] for m in stacked]).mean() for k in stacked[0]}
        tx.apply(state.optimizer, state.step)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def make_part_viz_fn(model: EmbedNet2) -> Callable:
    """Eval forward giving the fused part-parsing probabilities and the input
    resized to their grid (the reference's sample grid is built from these)."""

    @torch.no_grad()
    def fwd(rgb: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            out = model(xRGB=rgb, modal=1, with_feature=True)
        finally:
            model.train(was_training)
        fusion = out[2][0][1].to(torch.float32)   # part_preds = [(parsing, fusion), (edge,)]
        small = _resize(rgb, fusion.shape[1:3])
        return torch.softmax(fusion, dim=-1), small

    return fwd


def dump_part_samples(viz_fn, batch: Dict[str, Any], path: str, n_part: int = 7,
                      max_rows: int = 16) -> None:
    """One grid row per example: [image, GT part map, predicted part map,
    per-class probability maps]."""
    from vqvae2_tpu_torch.utils.image import save_image

    probs, small = viz_fn(batch["rgb"])
    probs, small = probs.cpu().numpy(), small.cpu().numpy()
    k = min(probs.shape[0], max_rows)
    h, w = probs.shape[1:3]

    # GT labels -> nearest-neighbour resize to the prediction grid
    gt = np.asarray(torch.as_tensor(batch["part1"]).cpu())[:k].astype(np.float32)
    yi = (np.arange(h) * gt.shape[1] / h).astype(np.int64)
    xi = (np.arange(w) * gt.shape[2] / w).astype(np.int64)
    gt = gt[:, yi][:, :, xi]
    gt = np.where(gt < 0, 0.0, gt)

    to3 = lambda m: np.repeat(m[..., None], 3, axis=-1) * 2.0 - 1.0
    rows = []
    for i in range(k):
        cols = [small[i], to3(gt[i] / max(n_part - 1, 1)),
                to3(np.argmax(probs[i], -1) / max(n_part - 1, 1))]
        cols += [to3(probs[i, :, :, c]) for c in range(probs.shape[-1])]
        rows.extend(cols)
    save_image(np.stack(rows), path, nrow=3 + probs.shape[-1])


def make_synthetic_sysu(tmpdir: str, n_ids: int = 8, per_id: int = 8, h: int = IMG_H,
                        w: int = IMG_W, seed: int = 0) -> str:
    """Fabricate the SYSU npy-blob layout for smoke runs."""
    rng = np.random.default_rng(seed)
    os.makedirs(tmpdir, exist_ok=True)
    n = n_ids * per_id
    labels = np.repeat(np.arange(n_ids), per_id)
    for mod in ("rgb", "ir"):
        np.save(f"{tmpdir}/train+Val_{mod}_resized_img.npy",
                rng.integers(0, 255, size=(n, h, w, 3)).astype(np.uint8))
        np.save(f"{tmpdir}/train+Val_{mod}_resized_label.npy", labels)
        np.save(f"{tmpdir}/train+Val_{mod}_resized_camera.npy", rng.integers(1, 7, size=(n,)))
        part = rng.integers(0, 7, size=(n, h, w)).astype(np.uint8)
        np.save(f"{tmpdir}/train+Val_{mod}_resized_part.npy", part)
    return tmpdir


def collate(rows, img_hw=(IMG_H, IMG_W)) -> Dict[str, np.ndarray]:
    """Stack a list of ``SYSUData`` part-mode items into a host batch; crops
    are padded back to the full size (parts with the ignore label)."""
    rgb = np.stack([r[0] for r in rows])
    ir = np.stack([r[1] for r in rows])
    label = np.asarray([r[2] for r in rows], np.int32)
    p1 = np.stack([r[6] for r in rows]).astype(np.int32)
    p2 = np.stack([r[7] for r in rows]).astype(np.int32)
    gray = np.stack([r[8] for r in rows])

    def pad(x, value=0):
        ph, pw = img_hw[0] - x.shape[1], img_hw[1] - x.shape[2]
        widths = [(0, 0), (0, ph), (0, pw)] + [(0, 0)] * (x.ndim - 3)
        return np.pad(x, widths, constant_values=value)

    return {"rgb": pad(rgb), "ir": pad(ir), "gray": pad(gray),
            "label": label, "part1": pad(p1, C.IGNORE), "part2": pad(p2, C.IGNORE)}


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=True, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // (loader_batch * args.grad_accum), 1)
    total_steps = args.steps or steps_per_epoch * args.epoch
    img_hw = dataset.train_color_image.shape[1:3]

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = EmbedNet2(class_num=dataset.num_class, arch=args.arch,
                          dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    if args.pretrained:
        # each modality stem and the shared trunk get the same pretrained base
        from vqvae2_tpu_torch.models.resnet import import_torchvision_resnet

        n = import_torchvision_resnet(model, args.pretrained)
        if par.is_primary():
            print(f"imported {n} backbone tensors from {args.pretrained}", flush=True)
    tx = make_optimizer(args.lr_F, steps_per_epoch)
    state = create_state(model, tx)
    par.replicate(state.model)
    step_fn = make_train_step(model, tx, args.num_pos, args.batch_size, img_hw,
                              grad_accum=args.grad_accum, seed=args.seed + 1)
    viz_fn = make_part_viz_fn(model) if args.sample_dir else None

    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    csv = CsvLogger(args.metrics_csv if par.is_primary() else "")
    map_csv = CsvLogger(args.map_csv if par.is_primary() else "")
    n_done, t0, m = 0, time.perf_counter(), {}
    epoch, buf = 0, []
    while n_done < total_steps:
        epoch += 1
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            buf.append(collate(rows, img_hw))       # the global batch, on the host
            if len(buf) < args.grad_accum:
                continue
            viz_batch, micro = buf[-1], buf
            buf = []
            state, metrics = step_fn(state, micro[0] if args.grad_accum == 1 else micro)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if par.is_primary():
                    rate = n_done * loader_batch * args.grad_accum / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} loss {m['loss']:.3f} id {m['id']:.3f} "
                          f"tri {m['tri']:.3f} part {m['part']:.3f} acc {m['acc']:.3f} "
                          f"({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if viz_fn is not None and n_done % args.sample_every == 0 and par.is_primary():
                dump_part_samples(viz_fn, to_device(viz_batch, device),
                                  f"{args.sample_dir}/part_{n_done:05d}.png",
                                  n_part=model.part_num)
            if n_done >= total_steps:
                break
        if args.eval_every and args.eval_path and epoch % args.eval_every == 0:
            # periodic CMC/mAP validation, on the primary rank in eval mode
            from vqvae2_tpu_torch.eval.reid import validate

            mAP = par.from_primary(validate(model, args.eval_path, img_size=(img_hw[1], img_hw[0]),
                                            trials=args.eval_trials)
                                   if par.is_primary() else 0.0, device)
            m["mAP"] = mAP
            map_csv.log(n_done, {"epoch": epoch, "mAP": mAP})
            if ckpt and ckpt.save_best(mAP, state.state_dict()) and par.is_primary():
                print(f"epoch {epoch}: new best mAP {mAP:.4f}", flush=True)
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="ReID + part parsing trainer (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=6, help="identities P")
    p.add_argument("--num_pos", type=int, default=4, help="instances K")
    p.add_argument("--lr_F", type=float, default=0.1)
    p.add_argument("--arch", type=str, default="resnet50")
    p.add_argument("--pretrained", type=str, default="",
                   help="torchvision resnet state_dict (.pt) for the backbone")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--img_h", type=int, default=IMG_H)
    p.add_argument("--img_w", type=int, default=IMG_W)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--sample_dir", type=str, default="",
                   help="dump part-parsing grids here")
    p.add_argument("--sample_every", type=int, default=300)
    p.add_argument("--eval_every", type=int, default=0,
                   help="validate CMC/mAP every N epochs (reference: 4)")
    p.add_argument("--eval_path", type=str, default="",
                   help="raw SYSU-MM01 root (cam1..cam6 + exp/test_id.txt)")
    p.add_argument("--eval_trials", type=int, default=1)
    p.add_argument("--grad_accum", type=int, default=1,
                   help="K P×K microbatches a step (one SGD update per superbatch)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/matmul compute (fp32 params, fp32 "
                        "losses and BN statistics)")
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-step scalar metrics to this CSV")
    p.add_argument("--map_csv", type=str, default="",
                   help="append per-validation (epoch, mAP) rows to this CSV")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    resolve_device(args.device)
    if not args.synthetic:
        return par.launch(train, args, device=args.device)
    # every rank writes the same corpus from the same seed into its own directory
    return par.launch(train_synthetic, args, device=args.device)


def train_synthetic(args) -> Dict[str, float]:
    """``train`` on a synthetic SYSU corpus in a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="sysu_syn_") as tmp:
        args.path = make_synthetic_sysu(tmp, h=args.img_h, w=args.img_w)
        return train(args)


if __name__ == "__main__":
    main()
