"""Bidirectional cycle trainer (port of ``vqvae2_tpu/train/vqvae_deep_bi.py``):
two ``VQVAE_Deep`` adaptors (gray -> IR through ``adaptor1``, IR -> gray
through ``adaptor2``) trained by cycle reconstruction, a feature-space
modality discriminator over ``2 * class_num`` labels, and a ReID net.

Per batch, as the JAX package's step:

1. On the host: an elastic warp and random box erasing of both views
   (:func:`aug_transforms`, numpy and scipy; the same draws from the same
   ``np.random.Generator`` in the same order as the JAX package's cv2 warp),
   and a random convex mix of the RGB channels as the gray view.
2. **Generator step** (Adam) with the ReID net and the discriminator frozen
   (their parameters take no gradient; the ReID net's batch norms in eval
   mode): the styles are the person features of the augmented views; the
   cycle gray -> IR -> gray and IR -> gray -> IR (four ``VQVAE_Deep`` passes,
   eight launches of the statistics kernel), the cycle MSE against the
   channel means, 0.25 * latent, and half of the translated views' identity
   CE, the center-margin feature loss with two cross triplets, and the
   discriminator's fake CE.
3. **ReID step** on the detached translations, batch norms in train mode: the
   identity CE over the real and translated views, weighted-regularisation
   triplets per modality, the modal-free feature MSE and the discriminator's
   real-modality CE.  Its optimizer (``person_id`` and ``discriminator``) is
   ``add_decayed_weights(5e-4)`` then Nesterov SGD at :func:`reid_lr_schedule`.

Data parallel (``parallel``): every rank draws the global batch's
augmentations from the same generator and takes its rows.  The batch norms
and the quantizers' EMA take the global batch's statistics; the centers,
margins and triplets run on the global features (``gather_batch``); every
other term is this rank's share of a mean over the rows.  So a world of N
ranks takes the single-process step.  ``main`` runs ``train`` through
``parallel.launch``; logs and checkpoint files come from the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.vqvae_deep_bi --synthetic [flags]``.
The device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from vqvae2_tpu_torch import losses as L
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData
from vqvae2_tpu_torch.models.adaptive import ModelAdaptiveBi_Deep, frozen, mode
from vqvae2_tpu_torch.train.adaptive import AdaptiveState, run_synthetic
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.metrics import CsvLogger

LATENT_LOSS_WEIGHT = 0.25


# ---------------------------------------------------------------------------
# host-side augmentations
# ---------------------------------------------------------------------------

def random_crop_boxes(imgs: np.ndarray, rng: np.random.Generator, n: int = 7,
                      size: int = 30, p: float = 0.5) -> np.ndarray:
    imgs = imgs.copy()
    H, W = imgs.shape[1:3]
    for img in imgs:
        if rng.random() > p:
            continue
        h = int(rng.integers(max(size - 15, 1), size + 10))
        w = int(rng.integers(max(size - 15, 1), size + 10))
        h, w = min(h, H - 1), min(w, W - 1)
        ys = rng.integers(0, H - h, n)
        xs = rng.integers(0, W - w, n)
        for y, x in zip(ys, xs):
            img[y:y + h, x:x + w] = rng.random()
    return imgs


def gaussian_blur(u: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(u, (k, k), sigma)`` with ``k = int(4 sigma) | 1``:
    the same taps, and cv2's default border (reflect-101) is scipy's
    ``mirror``."""
    k = int(sigma * 4) | 1
    return ndimage.gaussian_filter(u, sigma, mode="mirror", truncate=(k // 2) / sigma)


def elastic_maps(rng: np.random.Generator, h: int, w: int, alpha: float = 25.0,
                 sigma: float = 5.0) -> Tuple[np.ndarray, np.ndarray]:
    """The sampling coordinates ``(x, y)`` of one elastic warp, float32 as cv2
    takes them: the pixel grid plus blurred uniform noise, dx drawn first."""
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    dx = gaussian_blur(rng.uniform(-1, 1, size=(h, w)).astype(np.float32), sigma) * alpha / w
    dy = gaussian_blur(rng.uniform(-1, 1, size=(h, w)).astype(np.float32), sigma) * alpha / h
    return gx + dx * w, gy + dy * h


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR, borderMode=BORDER_REFLECT)``
    of an ``(H, W, C)`` image: bilinear, and cv2's reflect border is scipy's
    ``reflect``."""
    return np.stack([ndimage.map_coordinates(img[..., c], [map_y, map_x], order=1,
                                             mode="reflect")
                     for c in range(img.shape[-1])], axis=-1)


def elastic_transform(imgs: np.ndarray, rng: np.random.Generator,
                      alpha: float = 25.0, sigma: float = 5.0) -> np.ndarray:
    """Per-image elastic warp (torchvision ``ElasticTransform(alpha=25)``)."""
    out = np.empty_like(imgs)
    h, w = imgs.shape[1:3]
    for i, img in enumerate(imgs):
        out[i] = remap(img, *elastic_maps(rng, h, w, alpha, sigma))
    return out


def aug_transforms(imgs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return random_crop_boxes(elastic_transform(imgs, rng), rng)


def random_gray(rgb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """A random convex mix of each image's channels (weights uniform + 0.01,
    normalised), repeated to three channels."""
    wmix = rng.random((len(rgb), 3)) + 0.01
    wmix /= wmix.sum(axis=1, keepdims=True)
    return np.repeat(np.einsum("bhwc,bc->bhw", rgb, wmix)[..., None], 3,
                     axis=-1).astype(np.float32)


def cross_modal_batch(rows, rng: np.random.Generator, device) -> Dict[str, torch.Tensor]:
    """A list of ``SYSUData`` items as the cross-modal trainers collate it:
    the gray mix, then the augmented RGB and IR views, from ``rng`` in the
    JAX package's order; ``{"ir", "gray", "aug_rgb", "aug_ir", "label"}`` on
    ``device``."""
    rgb = np.stack([r[0] for r in rows])
    ir = np.stack([r[1] for r in rows])
    gray = random_gray(rgb, rng)
    batch = {"ir": ir, "gray": gray, "aug_rgb": aug_transforms(rgb, rng),
             "aug_ir": aug_transforms(ir, rng),
             "label": np.asarray([r[2] for r in rows], np.int32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def reid_lr_schedule(lr_f: float, steps_per_epoch: int) -> schedules.Schedule:
    """Warmup over 10 epochs, then flat, x0.1 from epoch 20 and x0.01 from 50;
    the epoch is that of the updates made before the step."""
    def sched(step):
        e = step // steps_per_epoch
        return (lr_f * (e + 1) / 10.0 if e < 10 else lr_f if e < 20
                else lr_f * 0.1 if e < 50 else lr_f * 0.01)
    return sched


def _split(model: ModelAdaptiveBi_Deep):
    """``(ReID parameters, generator parameters)``: ``person_id`` and
    ``discriminator``, and the rest."""
    reid_names = ("person_id.", "discriminator.")
    reid = [p for n, p in model.named_parameters() if n.startswith(reid_names)]
    gen = [p for n, p in model.named_parameters() if not n.startswith(reid_names)]
    return reid, gen


def create_state(model: ModelAdaptiveBi_Deep, tx_reid: schedules.SGDSchedule,
                 tx_gen: schedules.AdamSchedule) -> AdaptiveState:
    reid, gen = _split(model)
    return AdaptiveState(step=0, model=model.train(), opt_reid=tx_reid.build(reid),
                         opt_gen=tx_gen.build(gen))


def _e3(x: torch.Tensor) -> torch.Tensor:
    return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x


def _cycle_forward(model: ModelAdaptiveBi_Deep, gray, ir, featV, featI):
    """gray -> IR -> gray and IR -> gray -> IR; each quantizer takes an EMA
    step at each of its two calls."""
    g_b, g_t = model.encode_content_1(gray)
    g_content, lat1 = model.quantize_content_1(g_b, g_t, train=True)
    gray2ir = _e3(model.decode_1(g_content, featI))

    i_b, i_t = model.encode_content_2(ir)
    i_content, lat2 = model.quantize_content_2(i_b, i_t, train=True)
    ir2gray = _e3(model.decode_2(i_content, featV))

    f_b, f_t = model.encode_content_2(gray2ir)
    f_content, lat3 = model.quantize_content_2(f_b, f_t, train=True)
    gray2ir2gray = _e3(model.decode_2(f_content, featV))

    r_b, r_t = model.encode_content_1(ir2gray)
    r_content, lat4 = model.quantize_content_1(r_b, r_t, train=True)
    ir2gray2ir = _e3(model.decode_1(r_content, featI))

    return gray2ir, ir2gray, gray2ir2gray, ir2gray2ir, lat1 + lat2 + lat3 + lat4


def make_train_step(model: ModelAdaptiveBi_Deep, tx_reid: schedules.SGDSchedule,
                    tx_gen: schedules.AdamSchedule, num_pos: int):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds the global batch's ``gray``, ``ir``, ``aug_rgb``, ``aug_ir`` ``(B,
    H, W, 3)`` and ``label`` ``(B,)`` (numpy arrays or tensors, host or
    device), of which this rank takes its rows.  The metrics are the global
    batch's."""
    device = next(model.parameters()).device

    def train_step(state: AdaptiveState, batch: Dict[str, torch.Tensor]):
        rows = batch["label"].shape[0]
        local = par.local_batch(batch, device)
        label = local["label"].long()
        label_all = torch.as_tensor(batch["label"]).to(device).long()
        gray, ir = local["gray"], local["ir"]
        mse = lambda a, b: par.share_mean(torch.square(a - b), rows)     # noqa: E731
        ce = lambda s, y, groups=1: par.share_mean(                       # noqa: E731
            F.cross_entropy(s, y, reduction="none"), groups * rows)
        gather = lambda f: par.gather_batch(f, rows)                      # noqa: E731

        # generator step: the ReID net and the discriminator frozen
        state.opt_gen.zero_grad(set_to_none=True)
        with torch.no_grad(), mode(model.person_id, False):
            feat = model.person_id(xRGB=local["aug_rgb"], xIR=local["aug_ir"], modal=0,
                                   with_feature=True)[0]
        featV, featI = torch.chunk(feat, 2, dim=0)
        gray2ir, ir2gray, gray2ir2gray, ir2gray2ir, latent = _cycle_forward(
            model, gray, ir, featV, featI)
        with frozen(model.person_id), frozen(model.discriminator), \
                mode(model.person_id, False):
            featZ_v, scoreZ_v, *_ = model.person_id(xZ=gray2ir, modal=3, with_feature=True)
            featZ_i, scoreZ_i, *_ = model.person_id(xZ=ir2gray, modal=3, with_feature=True)
            d_fake = model.discriminate(torch.cat([featZ_v, featZ_i], dim=0))
        gray_target = torch.mean(gray, dim=-1, keepdim=True).repeat(1, 1, 1, 3)
        ir_target = torch.mean(ir, dim=-1, keepdim=True).repeat(1, 1, 1, 3)
        cycle = mse(ir2gray2ir, ir_target) + mse(gray2ir2gray, gray_target)
        latent = latent * (label.shape[0] / rows)
        loss_g = cycle + LATENT_LOSS_WEIGHT * latent
        loss_id_ir = (ce(scoreZ_v, label) + ce(scoreZ_i, label)) / 2
        # center-margin: translated centers closer than real cross-modal
        # centers by a margin of 0.01, over the global batch's identities
        n = rows // num_pos
        center = lambda f: f.reshape(n, num_pos, -1).mean(dim=1)     # noqa: E731
        zv, zi = gather(featZ_v), gather(featZ_i)
        pos = torch.mean(torch.square(center(zv) - center(zi)), dim=1)
        neg = torch.mean(torch.square(center(gather(featV)) - center(gather(featI))), dim=1)
        margin_loss = torch.mean(torch.clamp(0.01 + pos - neg, min=0.0))
        pair_feat = (margin_loss
                     + L.cross_triplet_loss(zv, zi, zv, label_all, label_all, label_all)
                     + L.cross_triplet_loss(zi, zv, zi, label_all, label_all, label_all))
        disc_fake = ce(d_fake, torch.cat([2 * label + 1, 2 * label]), 2)
        shares = loss_g + 0.5 * (loss_id_ir + disc_fake)
        (shares + 0.5 * pair_feat).backward()
        par.all_reduce_grads(state.opt_gen)
        schedules.fill_missing_grads(state.opt_gen)
        tx_gen.apply(state.opt_gen, state.step)
        state.opt_gen.step()

        # ReID step on the detached translations
        state.opt_reid.zero_grad(set_to_none=True)
        inter_v, inter_i = gray2ir.detach(), ir2gray.detach()
        with mode(model.person_id, True):
            feat, score, *_ = model.person_id(xRGB=local["aug_rgb"], xIR=local["aug_ir"],
                                              modal=0, with_feature=True)
            fZv, sZv = model.person_id(xIR=inter_v, modal=2)
            fZi, sZi = model.person_id(xRGB=inter_i, modal=1)
        d_real = model.discriminate(torch.cat([feat.detach(),
                                               torch.cat([fZv, fZi], dim=0).detach()], dim=0))
        featV, featI = torch.chunk(feat, 2, dim=0)
        loss_id = ce(torch.cat([score, sZv, sZi], dim=0),
                     torch.cat([label, label, label, label]), 4)
        loss_tri = (L.triplet_loss_wrt(gather(featV), label_all)[0]
                    + L.triplet_loss_wrt(gather(featI), label_all)[0])
        modal_free = mse(fZv, featV.detach()) + mse(fZi, featI.detach())
        modal_true = torch.cat([2 * label, 2 * label + 1, 2 * label, 2 * label + 1])
        disc_true = ce(d_real, modal_true, 4)
        shares_re = loss_id + modal_free + disc_true
        (shares_re + loss_tri).backward()
        par.all_reduce_grads(state.opt_reid)
        schedules.fill_missing_grads(state.opt_reid)
        tx_reid.apply(state.opt_reid, state.step)
        state.opt_reid.step()
        state.step += 1
        return state, par.global_metrics(
            {"cycle": cycle, "latent": latent, "id_ir": loss_id_ir, "disc_fake": disc_fake,
             "loss_gen": shares, "loss_reid": shares_re},
            {"feat_ir": pair_feat, "loss_gen": 0.5 * pair_feat, "loss_reid": loss_tri})

    return train_step


def build_model(args, num_class: int, device) -> ModelAdaptiveBi_Deep:
    """``ModelAdaptiveBi_Deep(class_num, arch)`` with weights drawn from
    ``--seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return ModelAdaptiveBi_Deep(class_num=num_class, arch=args.arch).to(device)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=False, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // loader_batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    model = build_model(args, dataset.num_class, device)
    tx_reid = schedules.SGDSchedule(reid_lr_schedule(args.lr_F, steps_per_epoch),
                                    momentum=0.9, nesterov=True, weight_decay=5e-4)
    tx_gen = schedules.adam(args.lr)
    state = create_state(model, tx_reid, tx_gen)
    if args.resume and args.ckpt_dir:
        restored, name = CheckpointManager(args.ckpt_dir).restore_latest(map_location=device)
        if name:
            state.load_state_dict(restored)
        if par.is_primary():
            print(f"resumed from {args.ckpt_dir}/{name}" if name else
                  f"no checkpoint in {args.ckpt_dir}; starting fresh", flush=True)
    par.replicate(state.model)
    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    step_fn = make_train_step(model, tx_reid, tx_gen, args.num_pos)
    host_rng = np.random.default_rng(args.seed)

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    n_done, m, t0 = 0, {}, time.perf_counter()
    while n_done < total_steps:
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            batch = cross_modal_batch(rows, host_rng, "cpu")   # the global batch
            state, metrics = step_fn(state, batch)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if primary:
                    rate = n_done * loader_batch / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} gen {m['loss_gen']:.3f} "
                          f"reid {m['loss_reid']:.3f} cycle {m['cycle']:.4f} "
                          f"latent {m['latent']:.4f} ({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if ckpt and args.save_every and n_done % args.save_every == 0:
                ckpt.save_periodic(n_done, state.state_dict())
            if n_done >= total_steps:
                break
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="Bidirectional cycle trainer (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_pos", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_F", type=float, default=0.1)
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--ckpt_dir", type=str, default="",
                   help="periodic/last checkpoints (off if empty)")
    p.add_argument("--save_every", type=int, default=0,
                   help="periodic checkpoint cadence in steps (0 = last only)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest step_*/last checkpoint from --ckpt_dir")
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    return run_synthetic(train, build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
