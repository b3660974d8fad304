"""Single-direction gray -> IR trainer with a staged curriculum (port of
``vqvae2_tpu/train/vqvae_deep_ir.py``) on ``ModelAdaptive_Deep``.

The first ``--stage_reconstruction`` epochs (steps, when ``--steps`` is
given) run pure IR reconstruction (:func:`make_recon_step`: encode, quantize
and decode the IR view with a zero style; MSE against its channel mean +
0.25 * latent; the statistics kernel twice a step).  After that each batch
runs the full step (:func:`make_full_step`), as the JAX package's:

1. ``gen_inter``, nothing differentiated: the ReID net in train mode on the
   augmented RGB view, the gray view fused with its x3 / x4 features (the
   fusions' statistics move), quantized (an EMA step) and decoded with its
   pooled feature as the style -> ``inter``, the fake IR view;
2. **ReID step** (Adam): identity CE over the RGB, IR and fake views, three
   cross triplets, the modal-free MSE, and the discriminator's real CE,
   which reaches no parameter of this step (the discriminator belongs to the
   generator's optimizer, as in the JAX package);
3. **generator step** (Adam, every parameter but the ReID net's, which runs
   frozen and in eval mode on the statistics step 2 wrote): the gray view
   fused and decoded again (a second EMA step, the fusions' statistics move
   again), the fake's identity CE, the alignment of its feature centers with
   the mean of the RGB and IR centers, the discriminator's fake CE, all
   times 0.1, + 0.25 * latent.

The statistics kernel runs four times a full step; ``make_sample_fn`` runs
the lookup kernel four times a grid.

Data parallel (``parallel``): every rank draws the global batch's
augmentations and takes its rows.  The batch norms and the quantizers' EMA
take the global batch's statistics; the cross triplets and the feature
centers run on the global features (``gather_batch``); every other term is
this rank's share of a mean over the rows.  So a world of N ranks takes the
single-process step.  ``main`` runs ``train`` through ``parallel.launch``;
logs, samples and checkpoint files come from the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.vqvae_deep_ir --synthetic [flags]``.
The device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import losses as L
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData
from vqvae2_tpu_torch.models.adaptive import ModelAdaptive_Deep, frozen, mode
from vqvae2_tpu_torch.models.resnet import pool_dim
from vqvae2_tpu_torch.train.adaptive import AdaptiveState, create_state, run_synthetic
from vqvae2_tpu_torch.train.vqvae_deep import build_model
from vqvae2_tpu_torch.train.vqvae_deep_bi import _e3, cross_modal_batch
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.image import save_image
from vqvae2_tpu_torch.utils.metrics import CsvLogger

LATENT_LOSS_WEIGHT = 0.25
STAGE_RECONSTRUCTION = 40  # epochs


def make_recon_step(model: ModelAdaptive_Deep, tx_gen: schedules.AdamSchedule, feat_dim: int):
    """Pure reconstruction of the IR view with a zero style:
    ``step(state, batch) -> (state, metrics)``; ``batch`` the global batch,
    of which this rank takes its rows; the metrics the global batch's."""
    device = next(model.parameters()).device

    def step(state: AdaptiveState, batch: Dict[str, torch.Tensor]):
        rows = batch["ir"].shape[0]
        ir = par.local_batch(batch["ir"], device)
        state.opt_gen.zero_grad(set_to_none=True)
        zero_style = torch.zeros((ir.shape[0], feat_dim), dtype=ir.dtype, device=ir.device)
        b, t = model.encode_content(ir)
        content, latent = model.quantize_content(b, t, train=True)
        rec = _e3(model.decode(content, zero_style))
        target = torch.mean(ir, dim=-1, keepdim=True).repeat(1, 1, 1, 3)
        recon = par.share_mean(torch.square(rec - target), rows)
        latent = latent * (ir.shape[0] / rows)
        loss = recon + LATENT_LOSS_WEIGHT * latent
        loss.backward()
        par.all_reduce_grads(state.opt_gen)
        schedules.fill_missing_grads(state.opt_gen)
        tx_gen.apply(state.opt_gen, state.step)
        state.opt_gen.step()
        state.step += 1
        return state, par.global_metrics({"recon": recon, "latent": latent, "loss_gen": loss,
                                          "loss_reid": torch.zeros(())})

    return step


def make_full_step(model: ModelAdaptive_Deep, tx_reid: schedules.AdamSchedule,
                   tx_gen: schedules.AdamSchedule, num_pos: int):
    """``gen_inter``, the ReID step, the generator step:
    ``step(state, batch) -> (state, metrics)``; ``batch`` holds the global
    batch's ``gray``, ``ir``, ``aug_rgb``, ``aug_ir`` ``(B, H, W, 3)`` and
    ``label`` (numpy arrays or tensors, host or device), of which this rank
    takes its rows; the metrics are the global batch's."""
    device = next(model.parameters()).device

    def step(state: AdaptiveState, batch: Dict[str, torch.Tensor]):
        rows = batch["label"].shape[0]
        local = par.local_batch(batch, device)
        label = local["label"].long()
        lab = torch.as_tensor(batch["label"]).to(device).long()
        gray, aug_rgb = local["gray"], local["aug_rgb"]
        mse = lambda a, b: par.share_mean(torch.square(a - b), rows)     # noqa: E731
        ce = lambda s, y, groups=1: par.share_mean(                       # noqa: E731
            F.cross_entropy(s, y, reduction="none"), groups * rows)
        gather = lambda f: par.gather_batch(f, rows)                      # noqa: E731

        with torch.no_grad():       # gen_inter: gray fused with RGB person features
            featV, scoreV, feat2dV, _, f3V = model.encode_person(aug_rgb, train=True)
            b, t = model.encode_content(gray)
            bf, tf = model.fuse(b, t, f3V, feat2dV, train=True)
            content, _ = model.quantize_content(bf, tf, train=True)
            inter = _e3(model.decode(content, featV))

        state.opt_reid.zero_grad(set_to_none=True)
        with mode(model.person_id, True):
            featT, scoreT = model.person_id(xIR=local["aug_ir"], modal=2)
            featZ, scoreZ = model.person_id(xZ=inter, modal=3)
        with torch.no_grad():
            d_real = model.discriminate(torch.cat([featV, featT, featZ], dim=0))
        loss_id = ce(torch.cat([scoreV, scoreT, scoreZ], dim=0),
                     torch.cat([label, label, label]), 3)
        fv, ft, fz = gather(featV), gather(featT), gather(featZ)
        loss_tri = (L.cross_triplet_loss(fv, fz, fv, lab, lab, lab)
                    + L.cross_triplet_loss(ft, fz, ft, lab, lab, lab)
                    + L.cross_triplet_loss(fz, ft, fz, lab, lab, lab))
        modal_free = mse(featZ, featV)
        disc_true = ce(d_real, torch.cat([2 * label, 2 * label + 1, 2 * label]), 3)
        shares_re = loss_id + modal_free + disc_true
        (shares_re + loss_tri).backward()
        par.all_reduce_grads(state.opt_reid)
        schedules.fill_missing_grads(state.opt_reid)
        tx_reid.apply(state.opt_reid, state.step)
        state.opt_reid.step()
        ft = ft.detach()

        state.opt_gen.zero_grad(set_to_none=True)
        with torch.no_grad():
            fV, _, feat2dV, _, f3V = model.encode_person(aug_rgb, train=False)
        b, t = model.encode_content(gray)
        bf, tf = model.fuse(b, t, f3V, feat2dV, train=True)
        content, latent = model.quantize_content(bf, tf, train=True)
        inter = _e3(model.decode(content, fV))
        with frozen(model.person_id), mode(model.person_id, False):
            featG, score, *_ = model.person_id(xIR=inter, modal=2, with_feature=True)
        d_fake = model.discriminate(featG)
        loss_id_ir = ce(score, label)
        n = rows // num_pos
        grp = lambda f: f.reshape(n, num_pos, -1)              # noqa: E731
        centerV, centerT = grp(fv.detach()).mean(dim=1), grp(ft).mean(dim=1)
        centerG = grp(gather(featG)).mean(dim=1)
        loss_feat_ir = torch.mean(torch.square(centerG - (centerV + centerT) / 2))
        disc_fake = ce(d_fake, 2 * label + 1)
        latent = latent * (label.shape[0] / rows)
        shares = 0.1 * (loss_id_ir + disc_fake) + LATENT_LOSS_WEIGHT * latent
        (shares + 0.1 * loss_feat_ir).backward()
        par.all_reduce_grads(state.opt_gen)
        schedules.fill_missing_grads(state.opt_gen)
        tx_gen.apply(state.opt_gen, state.step)
        state.opt_gen.step()
        state.step += 1
        return state, par.global_metrics(
            {"latent": latent, "id_ir": loss_id_ir, "disc_fake": disc_fake, "loss_gen": shares,
             "recon": torch.zeros(()), "loss_reid": shares_re},
            {"feat_ir": loss_feat_ir, "loss_gen": 0.1 * loss_feat_ir, "loss_reid": loss_tri})

    return step


def make_sample_fn(model: ModelAdaptive_Deep, feat_dim: int):
    """An eval-mode pass for the sample grids: ``sample(batch) -> (gray -> IR
    translation, IR reconstruction with a zero style)``; nothing of the model
    moves."""

    @torch.no_grad()
    def sample(batch: Dict[str, torch.Tensor]):
        featV, _, feat2dV, _, f3V = model.encode_person(batch["aug_rgb"], train=False)
        b, t = model.encode_content(batch["gray"])
        bf, tf = model.fuse(b, t, f3V, feat2dV, train=False)
        content, _ = model.quantize_content(bf, tf, train=False)
        inter = _e3(model.decode(content, featV))
        ir = batch["ir"]
        b2, t2 = model.encode_content(ir)
        c2, _ = model.quantize_content(b2, t2, train=False)
        zero_style = torch.zeros((ir.shape[0], feat_dim), dtype=ir.dtype, device=ir.device)
        return inter, _e3(model.decode(c2, zero_style))

    return sample


def dump_samples(sample_fn, batch: Dict[str, torch.Tensor], path: str,
                 max_rows: int = 8) -> None:
    """Grid rows [augmented RGB, gray, gray -> IR, real IR, IR recon]."""
    inter, ir_rec = sample_fn(batch)
    k = min(int(batch["ir"].shape[0]), max_rows)
    take = lambda t: t[:k].float().cpu().numpy()            # noqa: E731
    grid = np.concatenate([take(batch["aug_rgb"]), take(batch["gray"]), take(inter),
                           take(batch["ir"]), take(ir_rec)], axis=0)
    save_image(grid, path, nrow=k)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=False, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // loader_batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    model = build_model(args, dataset.num_class, device)
    tx_reid, tx_gen = schedules.adam(args.lr_reid), schedules.adam(args.lr)
    state = create_state(model, tx_reid, tx_gen)
    # the stage follows n_done, which restarts at 0: a resumed run re-runs
    # the reconstruction stage unless --stage_reconstruction is lowered
    if args.resume and args.ckpt_dir:
        restored, name = CheckpointManager(args.ckpt_dir).restore_latest(map_location=device)
        if name:
            state.load_state_dict(restored)
        if par.is_primary():
            print(f"resumed from {args.ckpt_dir}/{name}" if name else
                  f"no checkpoint in {args.ckpt_dir}; starting fresh", flush=True)
    par.replicate(state.model)
    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    recon_step = make_recon_step(model, tx_gen, pool_dim(args.arch))
    full_step = make_full_step(model, tx_reid, tx_gen, args.num_pos)
    sample_fn = make_sample_fn(model, pool_dim(args.arch)) if args.sample_dir else None
    host_rng = np.random.default_rng(args.seed)
    stage_steps = (args.stage_reconstruction if args.steps
                   else args.stage_reconstruction * steps_per_epoch)

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    n_done, m, t0 = 0, {}, time.perf_counter()
    while n_done < total_steps:
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            batch = cross_modal_batch(rows, host_rng, "cpu")   # the global batch
            fn = recon_step if n_done < stage_steps else full_step
            state, metrics = fn(state, batch)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if primary:
                    rate = n_done * loader_batch / (time.perf_counter() - t0)
                    stage = "recon" if n_done <= stage_steps else "full"
                    print(f"step {n_done}/{total_steps} [{stage}] gen {m['loss_gen']:.3f} "
                          f"reid {m['loss_reid']:.3f} latent {m['latent']:.4f} "
                          f"({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if sample_fn is not None and n_done % args.sample_every == 0 and primary:
                dump_samples(sample_fn, {k: v.to(device) for k, v in batch.items()},
                             f"{args.sample_dir}/{n_done:05d}.png")
            if ckpt and args.save_every and n_done % args.save_every == 0:
                ckpt.save_periodic(n_done, state.state_dict())
            if n_done >= total_steps:
                break
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="Gray->IR staged trainer (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--stage_reconstruction", type=int, default=STAGE_RECONSTRUCTION)
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
