"""Gray -> color adaptation trainer (port of ``vqvae2_tpu/train/gray2color.py``):
``ModelAdaptive`` with its style-encoder branch, non-local fusion of the IR
view's content with the style of the RGB view (and of another instance of the
same identity), recon + content-consistency + 0.25 * latent, one Adam over
every parameter (the ReID net takes no gradient: the forward never runs it).

The gray view is the IR view itself, as in the JAX package (which overrides
the random channel mix).  The "other" pairing rotates each identity's K
instances by a random non-zero offset (:func:`other_instance_ids`, a numpy
draw from ``--seed``, bit-equal to the JAX package's).  The model has no IR
decoder: flax never creates one for this trainer.

Data parallel (``parallel``): a step takes the global batch and each rank its
rows; the other instance's image of each row comes from the global batch on
the host, the quantizers' EMA and the batch norms take the global batch's
statistics, and every term is this rank's share of a mean over the rows, so
a world of N ranks takes the single-process step.  ``main`` runs ``train``
through ``parallel.launch``; logs, samples and checkpoint files come from the
primary rank.

Run: ``python -m vqvae2_tpu_torch.train.gray2color --synthetic [flags]``.  The
device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData
from vqvae2_tpu_torch.models.adaptive import ModelAdaptive
from vqvae2_tpu_torch.train.adaptive import build_model, run_synthetic, sysu_batch
from vqvae2_tpu_torch.train.vqvae import TrainState
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.image import save_image
from vqvae2_tpu_torch.utils.metrics import CsvLogger

LATENT_LOSS_WEIGHT = 0.25


def forward(model: ModelAdaptive, img1: torch.Tensor, img2: torch.Tensor,
            img1_other: torch.Tensor):
    """The generator pass (four statistics-kernel launches: two encodes, two
    codebooks each); ``img1_other`` holds each row's other instance."""
    feat2d = model.encode_style(img1)
    feat2d_other = model.encode_style(img1_other)
    gray = img2
    rgb_content, latent = model.encode_content(img1, train=True)
    rgb_reconst = model.decode(rgb_content)
    gray_content, _ = model.encode_content(gray, train=True)
    gray_itself = model.fuse(gray_content, feat2d, train=True)
    rgb_fake = model.decode(gray_itself)
    gray_other = model.fuse(gray_content, feat2d_other, train=True)
    rgb_fake_other = model.decode(gray_other)
    return (rgb_content, rgb_reconst, gray_itself, gray_other, rgb_fake, rgb_fake_other,
            latent)


def make_train_step(model: ModelAdaptive, tx: schedules.AdamSchedule):
    """Returns ``train_step(state, batch, ids) -> (state, (metrics, (recon,
    fake, fake_other)))``: ``batch`` is the global batch (numpy arrays or
    tensors, host or device), of which this rank takes its rows, and ``ids``
    each row's other instance among the global rows.  The metrics are the
    global batch's; the images this rank's rows'."""
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], ids: torch.Tensor):
        rows = batch["rgb"].shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        local = par.local_batch({"rgb": batch["rgb"], "ir": batch["ir"],
                                 "other": torch.as_tensor(batch["rgb"])[
                                     torch.as_tensor(ids).cpu()]}, device)
        img1 = local["rgb"]
        (rgb_content, rgb_reconst, gray_itself, gray_other, rgb_fake, rgb_fake_other,
         latent) = forward(model, img1, local["ir"], local["other"])
        mse = lambda a, b: par.share_mean(torch.square(a - b), rows)      # noqa: E731
        recon = mse(rgb_reconst, img1) + mse(rgb_fake, img1) + mse(rgb_fake_other, img1)
        recon_feat = mse(gray_itself, rgb_content) + mse(gray_other, rgb_content)
        latent = latent * (img1.shape[0] / rows)
        loss = recon_feat + recon + LATENT_LOSS_WEIGHT * latent
        loss.backward()
        par.all_reduce_grads(state.optimizer)
        tx.apply(state.optimizer, state.step)
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss, "recon": recon, "recon_feat": recon_feat, "latent": latent}
        images = tuple(t.detach() for t in (rgb_reconst, rgb_fake, rgb_fake_other))
        return state, (par.global_metrics(metrics), images)

    return train_step


def other_instance_ids(batch_ids: int, num_pos: int, rng: np.random.Generator) -> np.ndarray:
    """Rotate each identity's K instances by a random non-zero offset."""
    first = (np.arange(batch_ids) * num_pos)[:, None]
    r = rng.integers(1, num_pos, size=(batch_ids, 1))
    ids = (np.tile(np.arange(num_pos), batch_ids).reshape(-1, num_pos) + r) % num_pos + first
    return ids.reshape(-1)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=False, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // loader_batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    model = build_model(args, dataset.num_class, device, ir_head=False)
    tx = (schedules.cycle_adam(args.lr, total_steps) if args.sched == "cycle"
          else schedules.adam(args.lr))
    state = TrainState(step=0, model=model.train(), optimizer=tx.build(model.parameters()))
    if args.resume and args.ckpt_dir:
        restored, name = CheckpointManager(args.ckpt_dir).restore_latest(map_location=device)
        if name:
            state.load_state_dict(restored)
        if par.is_primary():
            print(f"resumed from {args.ckpt_dir}/{name}" if name else
                  f"no checkpoint in {args.ckpt_dir}; starting fresh", flush=True)
    par.replicate(state.model)
    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    step_fn = make_train_step(model, tx)
    host_rng = np.random.default_rng(args.seed)

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    n_done, m, t0 = 0, {}, time.perf_counter()
    while n_done < total_steps:
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            batch = sysu_batch(rows, "cpu")          # the global batch, on the host
            ids = torch.from_numpy(other_instance_ids(args.batch_size, args.num_pos,
                                                      host_rng))
            state, (metrics, images) = step_fn(state, batch, ids)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if primary:
                    rate = n_done * loader_batch / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} loss {m['loss']:.4f} "
                          f"recon {m['recon']:.4f} latent {m['latent']:.4f} "
                          f"({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if args.sample_every and n_done % args.sample_every == 0 and primary:
                # grid: rgb | ir | rgb recon | colorized | colorized with the
                # other instance's style (the primary's rows)
                k = min(8, images[0].shape[0])
                host = [t[:k].cpu().numpy() for t in (batch["rgb"], batch["ir"], *images)]
                save_image(np.concatenate(host, axis=0),
                           f"{args.sample_dir}/{n_done:05d}.png", nrow=k,
                           value_range=(-2.0, 2.0))
            if ckpt and args.save_every and n_done % args.save_every == 0:
                ckpt.save_periodic(n_done, state.state_dict())
            if n_done >= total_steps:
                break
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="Gray->color adaptation trainer (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--epoch", type=int, default=560)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_pos", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--sched", type=str, default="")
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--sample_dir", type=str, default="sample")
    p.add_argument("--sample_every", type=int, default=0,
                   help="dump [rgb|ir|recon|colorized|colorized-other] grids"
                        " every N steps (0 = off)")
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
