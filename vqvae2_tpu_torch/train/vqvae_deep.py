"""Deep adaptive trainer (port of ``vqvae2_tpu/train/vqvae_deep.py``):
``ModelAdaptive_Deep`` with a ReID step and a generator step a batch.

Per batch, as the JAX package's step:

1. **ReID step** (Adam #1) on the RGB view, batch norms in train mode: the
   identity CE + batch-hard triplet + the within-identity feature variance
   (the population variance, as ``jnp.var``).
2. The norm-attention map of that forward, snapped to {0, 1} around its
   median (``jnp.median``'s: the mean of the two middle values of an even
   count) and upsampled 16x bilinearly, masks the losses
   (:func:`threshold_up_mask`).
3. A random convex mix of the RGB channels is the gray view
   (:func:`random_gray`, drawn from a generator seeded from ``--seed`` and
   the step).
4. **Generator step** (Adam #2), with the ReID net's parameters as step 1
   left them: the RGB, gray and IR contents, the gray and IR ones fused with
   the masked x3 / x4 person features (and the gray one with another
   identity's, ``roll(arange(B), K)``), four ``quantize_content`` calls (the
   statistics kernel on both codebooks, eight launches), the masked
   reconstructions, the content consistency of the gray latents with the RGB
   one, 0.25 * latent, and the fake IR image's identity and feature losses
   through the ReID net *frozen*: its parameters take no gradient and its
   batch norms run in eval mode on the statistics step 1 wrote.

``make_sample_fn`` / ``dump_samples`` write the reference's sample grid from
an eval-mode pass (the lookup kernel, eight launches).  ``--eval_every N
--eval_path <raw SYSU-MM01 root>`` validates the ReID net every N epochs.

Data parallel (``parallel``): a step takes the global P×K batch and each rank
its rows.  The batch norms and the quantizers' EMA take the global batch's
statistics; the batch-hard triplet and the within-identity variance run on
the global features (``gather_batch``), as do the "other identity" rows of
``roll(arange(B), K)``, which for a rank's first rows come from the rank
before; the gray mix draws the global batch's weights and keeps this rank's
rows; every other term is this rank's share of a mean over the rows.  So a
world of N ranks takes the single-process step.  ``main`` runs ``train``
through ``parallel.launch``; logs, samples, validation and checkpoint files
come from the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.vqvae_deep --synthetic [flags]``.  The
device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import losses as L
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData
from vqvae2_tpu_torch.models.adaptive import ModelAdaptive_Deep, frozen
from vqvae2_tpu_torch.models.pixelsnail import batch_rows, draw_rows
from vqvae2_tpu_torch.part.part_model import _resize
from vqvae2_tpu_torch.train.adaptive import (AdaptiveState, create_state, run_synthetic,
                                             sysu_batch)
from vqvae2_tpu_torch.train.pixelsnail import step_generator
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.metrics import CsvLogger

LATENT_LOSS_WEIGHT = 0.25


def _e3(x: torch.Tensor) -> torch.Tensor:
    return x.repeat(1, 1, 1, 3) if x.shape[-1] == 1 else x


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the mean of the two middle values of
    an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def threshold_up_mask(act_map: torch.Tensor, hw):
    """The norm-attention map ``(B, h, w, 1)`` snapped to 0 below its median
    - 0.1 and to 1 above its median + 0.02, and that map resized bilinearly
    to the image size ``hw`` (``jax.image.resize``)."""
    bs = act_map.shape[0]
    m = median(act_map.reshape(bs, -1)).reshape(bs, 1, 1, 1)
    am = torch.where(act_map < m - 0.1, torch.zeros_like(act_map),
                     torch.where(act_map > m + 0.02, torch.ones_like(act_map), act_map))
    return am, _resize(am, hw)


def random_gray(generator: torch.Generator, img1: torch.Tensor) -> torch.Tensor:
    """A random convex mix of each image's channels (weights uniform + 0.01,
    normalised), repeated to three channels.  Inside ``batch_rows`` the
    weights are drawn for the global batch and this rank's rows kept."""
    rows, start = draw_rows(img1.shape[0])
    w = torch.rand((rows, 3), generator=generator, device=img1.device) + 0.01
    w = w[start:start + img1.shape[0]]
    w = w / torch.sum(w, dim=1, keepdim=True)
    return torch.einsum("bhwc,bc->bhw", img1, w)[..., None].repeat(1, 1, 1, 3)


def gen_forward(model: ModelAdaptive_Deep, img1, img2, gray, feat, mf3, mf4, mf3_other,
                mf4_other):
    """The generator pass of one step; the codebooks take four EMA steps and
    the fusions' statistics three.  ``mf3_other`` / ``mf4_other`` are the
    masked features of each row's other identity."""
    rgb_b, rgb_t = model.encode_content(img1)
    rgb_content, latent_rgb = model.quantize_content(rgb_b, rgb_t, train=True)
    rgb_reconst = model.decode(rgb_content, feat)

    gray_b, gray_t = model.encode_content(gray)
    gb_f, gt_f = model.fuse(gray_b, gray_t, mf3, mf4, train=True)
    gray_content, latent_gray = model.quantize_content(gb_f, gt_f, train=True)
    rgb_fake = model.decode(gray_content, feat)

    gb_o, gt_o = model.fuse(gray_b, gray_t, mf3_other, mf4_other, train=True)
    gray_other, latent_other = model.quantize_content(gb_o, gt_o, train=True)
    rgb_fake_other = model.decode(gray_other, feat)

    ir_b, ir_t = model.encode_content(img2)
    ib_f, it_f = model.fuse(ir_b, ir_t, mf3, mf4, train=True)
    ir_content, latent_ir = model.quantize_content(ib_f, it_f, train=True)
    ir_fake = model.decode(ir_content, feat)

    with frozen(model.person_id):
        feat_ir, score_ir, _, _, _ = model.encode_person(_e3(ir_fake), train=False)

    latent = latent_rgb + latent_gray + latent_other + latent_ir
    return (rgb_reconst, rgb_fake, rgb_fake_other, rgb_content, gray_content, gray_other,
            latent, feat_ir, score_ir)


def make_train_step(model: ModelAdaptive_Deep, tx_reid: schedules.AdamSchedule,
                    tx_gen: schedules.AdamSchedule, num_pos: int, seed: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds the global batch's ``rgb``, ``ir`` ``(B, H, W, 3)`` and ``label``
    ``(B,)`` (numpy arrays or tensors, host or device), of which this rank
    takes its rows.  The gray mix of a step comes from
    ``step_generator(seed, state.step)``.  The metrics are the global
    batch's."""
    device = next(model.parameters()).device

    def train_step(state: AdaptiveState, batch: Dict[str, torch.Tensor]):
        rows = batch["label"].shape[0]
        mse = lambda a, b: par.share_mean(torch.square(a - b), rows)     # noqa: E731
        local = par.local_batch(batch, device)
        img1, img2, label = local["rgb"], local["ir"], local["label"].long()
        label_all = torch.as_tensor(batch["label"]).to(device).long()
        bs, start = img1.shape[0], par.shard_rows(rows)[0]

        state.opt_reid.zero_grad(set_to_none=True)
        feat, score, feat2d, act_map, feat2d_x3 = model.encode_person(img1, train=True)
        feat_all = par.gather_batch(feat, rows)
        var = feat_all.reshape(rows // num_pos, num_pos, -1).var(dim=1, correction=0).mean()
        ce_re = par.share_mean(F.cross_entropy(score, label, reduction="none"), rows)
        pair_re = L.triplet_loss(feat_all, label_all)[0] + var
        (ce_re + pair_re).backward()
        par.all_reduce_grads(state.opt_reid)
        tx_reid.apply(state.opt_reid, state.step)
        state.opt_reid.step()
        feat, feat2d, act_map, feat2d_x3 = (t.detach() for t in (feat, feat2d, act_map,
                                                                 feat2d_x3))

        state.opt_gen.zero_grad(set_to_none=True)
        am, up_mask = threshold_up_mask(act_map, img1.shape[1:3])
        with batch_rows(start, rows):
            gray = random_gray(step_generator(seed, state.step, device), img1)
        mf3, mf4 = feat2d_x3 * am, feat2d * am
        # each row's other identity, K rows on: across the ranks' boundaries
        ids = torch.roll(torch.arange(rows, device=device), num_pos)
        mf3_other, mf4_other = (par.local_rows(par.gather_batch(t, rows)[ids], rows)
                                for t in (mf3, mf4))
        (rgb_reconst, rgb_fake, rgb_fake_other, rgb_content, gray_content, gray_other, latent,
         feat_ir, score_ir) = gen_forward(model, img1, img2, gray, feat, mf3, mf4, mf3_other,
                                          mf4_other)
        loss_id_ir = par.share_mean(F.cross_entropy(score_ir, label, reduction="none"), rows)
        loss_feat_ir = mse(feat_ir, feat)
        mask_img = img1 * up_mask
        recon = (mse(rgb_reconst * up_mask, mask_img) + mse(rgb_fake * up_mask, mask_img)
                 + mse(rgb_fake_other * up_mask, mask_img))
        recon_feat = mse(gray_content, rgb_content) + mse(gray_other, rgb_content)
        latent = latent * (bs / rows)
        total = recon_feat + recon + LATENT_LOSS_WEIGHT * latent + loss_id_ir + loss_feat_ir
        total.backward()
        par.all_reduce_grads(state.opt_gen)
        tx_gen.apply(state.opt_gen, state.step)
        state.opt_gen.step()
        state.step += 1
        return state, par.global_metrics(
            {"recon": recon, "recon_feat": recon_feat, "latent": latent, "id_ir": loss_id_ir,
             "feat_ir": loss_feat_ir, "loss_reid": ce_re, "loss_gen": total},
            {"loss_reid": pair_re})

    return train_step


def make_sample_fn(model: ModelAdaptive_Deep, num_pos: int):
    """An eval-mode generator pass for the sample grids: ``sample(batch,
    generator) -> (recon, gray->RGB fake, other-identity fake, IR fake,
    up_mask)``; nothing of the model moves."""

    @torch.no_grad()
    def sample(batch: Dict[str, torch.Tensor], generator: torch.Generator):
        img1, img2 = batch["rgb"], batch["ir"]
        feat, _, feat2d, act_map, feat2d_x3 = model.encode_person(img1, train=False)
        am, up_mask = threshold_up_mask(act_map, img1.shape[1:3])
        gray = random_gray(generator, img1)
        mf3, mf4 = feat2d_x3 * am, feat2d * am
        ids = torch.roll(torch.arange(img1.shape[0], device=img1.device), num_pos)

        def through(enc, f3, f4, fuse=True):
            b, t = model.encode_content(enc)
            if fuse:
                b, t = model.fuse(b, t, f3, f4, train=False)
            content, _ = model.quantize_content(b, t, train=False)
            return model.decode(content, feat)

        return (through(img1, None, None, fuse=False), through(gray, mf3, mf4),
                through(gray, mf3[ids], mf4[ids]), _e3(through(img2, mf3, mf4)), up_mask)

    return sample


def dump_samples(sample_fn, batch: Dict[str, torch.Tensor], generator: torch.Generator,
                 path: str, max_rows: int = 8) -> None:
    """One column per example, rows [real RGB, recon, gray->RGB fake,
    other-identity fake, real IR, IR fake, 2 * up_mask - 1]."""
    from vqvae2_tpu_torch.utils.image import save_image

    recon, fake, fake_other, ir_fake, up_mask = sample_fn(batch, generator)
    k = min(int(batch["rgb"].shape[0]), max_rows)
    take = lambda t: t[:k].float().cpu().numpy()            # noqa: E731
    mask3 = np.repeat(take(up_mask), 3, axis=-1) * 2.0 - 1.0
    grid = np.concatenate([take(batch["rgb"]), take(recon), take(fake), take(fake_other),
                           take(batch["ir"]), take(ir_fake), mask3], axis=0)
    save_image(grid, path, nrow=k)


def build_model(args, num_class: int, device) -> ModelAdaptive_Deep:
    """``ModelAdaptive_Deep(class_num, arch)`` with weights drawn from ``--seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return ModelAdaptive_Deep(class_num=num_class, arch=args.arch).to(device)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=False, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // loader_batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch
    h, w = dataset.train_color_image.shape[1:3]

    model = build_model(args, dataset.num_class, device)
    tx_reid, tx_gen = schedules.adam(args.lr_reid), schedules.adam(args.lr)
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
    step_fn = make_train_step(model, tx_reid, tx_gen, args.num_pos, seed=args.seed + 2)
    sample_fn = make_sample_fn(model, args.num_pos) if args.sample_dir else None

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    n_done, m, epoch = 0, {}, 0
    while n_done < total_steps:
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            batch = sysu_batch(rows, "cpu")          # the global batch, on the host
            state, metrics = step_fn(state, batch)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if primary:
                    print(f"step {n_done}/{total_steps} reid {m['loss_reid']:.3f} "
                          f"gen {m['loss_gen']:.3f} recon {m['recon']:.4f} "
                          f"latent {m['latent']:.4f}", flush=True)
                    csv.log(n_done, m)
            if sample_fn is not None and n_done % args.sample_every == 0 and primary:
                dump_samples(sample_fn, {k: v.to(device) for k, v in batch.items()},
                             step_generator(args.seed + 2, n_done, device),
                             f"{args.sample_dir}/{n_done:05d}.png")
            if ckpt and n_done % (steps_per_epoch * 10) == 0:
                ckpt.save_periodic(n_done, state.state_dict())
            if n_done >= total_steps:
                break
        epoch += 1
        if args.eval_every and args.eval_path and epoch % args.eval_every == 0:
            # person-ReID validation of the person_id subnet
            from vqvae2_tpu_torch.eval.reid import validate

            mAP = par.from_primary(validate(model.person_id, args.eval_path, img_size=(w, h),
                                            trials=args.eval_trials) if primary else 0.0,
                                   device)
            m["mAP"] = mAP
            if ckpt and ckpt.save_best(mAP, state.state_dict()) and primary:
                print(f"epoch {epoch}: new best mAP {mAP:.4f}", flush=True)
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="Deep adaptive trainer (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--epoch", type=int, default=560)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_pos", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_reid", type=float, default=3e-4)
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--sample_dir", type=str, default="",
                   help="dump sample grids here")
    p.add_argument("--sample_every", type=int, default=500)
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval_every", type=int, default=0,
                   help="validate CMC/mAP every N epochs (reference: 4)")
    p.add_argument("--eval_path", type=str, default="",
                   help="raw SYSU-MM01 root (cam1..cam6 + exp/test_id.txt)")
    p.add_argument("--eval_trials", type=int, default=1)
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    return run_synthetic(train, build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
