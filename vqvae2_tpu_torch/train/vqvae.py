"""Stage-1 VQ-VAE-2 trainer (port of ``vqvae2_tpu/train/vqvae.py``): MSE
reconstruction + 0.25 · latent loss, Adam at lr 3e-4, optional 1-cycle
schedule (``--sched cycle``), the codebooks' EMA update inside the forward.

One step: forward with ``train=True`` (which launches the statistics flavour of
the quantizer kernel twice and moves the codebook buffers in place), backward,
the schedule's values into the optimizer, ``optimizer.step()``.
``--grad_accum A`` splits the batch into ``A`` microbatches run one after the
other: each takes its own EMA step, the gradients are summed and divided by
``A``, and one optimizer update follows, as the JAX package's scan does.
``--bf16`` runs the convolutions in bf16 (``VQVAE(dtype=torch.bfloat16)``):
parameters, codebooks, the quantizer's search and the loss stay fp32.

Data parallel (``parallel``): a step takes the global batch and each rank its
rows (``shard_batch``, or ``shard_microbatches`` under ``--grad_accum``); the
rank backpropagates its share of the global-batch loss, the gradients are
summed over the ranks, and the quantizers take their EMA step on the global
batch's statistics, so a world of N ranks takes the single-process step.
``main`` runs ``train`` through ``parallel.launch``: under ``torchrun`` on
every rank (``nccl`` on cards, ``gloo`` with ``--device cpu``), else in one
process.  Logs, samples and checkpoints come from the primary rank.

Weights carried across from the JAX package (``utils/jax_import.py``:
parameters and all three codebook buffers) and a fresh Adam state on both sides
are how the two trainers are held against each other: no map of the optimizer
state is needed.

Run: ``python -m vqvae2_tpu_torch.train.vqvae <img_dir> [flags]``, or
``--synthetic`` for a run without a dataset.  The device defaults to ``cuda``;
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import (ImageFileDataset, SyntheticImages,
                                            iterate_batches, normalize_to_unit,
                                            to_unit_device)
from vqvae2_tpu_torch.models.vqvae import VQVAE, build_vqvae
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.image import save_image

LATENT_LOSS_WEIGHT = 0.25


@dataclass
class TrainState:
    """The model (parameters and codebook buffers), its optimizer, and the
    number of updates made."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_state(model: torch.nn.Module, tx: schedules.AdamSchedule) -> TrainState:
    return TrainState(step=0, model=model.train(), optimizer=tx.build(model.parameters()))


def make_train_step(model: VQVAE, tx: schedules.AdamSchedule,
                    latent_weight: float = LATENT_LOSS_WEIGHT, grad_accum: int = 1):
    """Returns ``train_step(state, x) -> (state, metrics)``.

    ``x`` is the global host or device batch ``(B, H, W, C)`` (uint8 is
    normalised on the device), or ``(grad_accum, rows, H, W, C)`` when
    ``grad_accum > 1``; under a process group this rank takes its rows of it.
    The metrics are this rank's, 0-dim tensors on the device (reading them
    synchronises; ``parallel.reduce_dict`` averages them over the ranks)."""
    device = next(model.parameters()).device

    def loss_fn(x):
        x = to_unit_device(x, device)
        dec, diff = model(x, train=True)
        recon = par.local_mean(torch.square(dec - x))
        return recon + latent_weight * diff, recon, diff

    def backward(x, rows: int):
        """This rank's share of the global batch's loss, backpropagated."""
        loss, recon, diff = loss_fn(x)
        (loss * (x.shape[0] / rows)).backward()
        return torch.stack([loss, recon, diff]).detach()

    def train_step(state: TrainState, x):
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            parts = backward(par.shard_batch(x), x.shape[0])
        else:
            # the EMA advances once a microbatch; backward sums their gradients
            parts = torch.stack([backward(xm, x.shape[1])
                                 for xm in par.shard_microbatches(x)]).mean(0)
        par.all_reduce_grads(model.parameters())
        if grad_accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        tx.apply(state.optimizer, state.step)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": parts[0], "recon_mse": parts[1], "latent": parts[2]}

    return train_step


def make_eval_step(model: VQVAE):
    """``eval_step(state, x) -> dec``: the reconstruction, codebooks frozen."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def eval_step(state: TrainState, x):
        dec, _ = model(to_unit_device(x, device))
        return dec

    return eval_step


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise SystemExit(f"--batch_size {args.batch_size} not divisible by "
                         f"--grad_accum {args.grad_accum}")
    if args.synthetic:
        dataset = SyntheticImages(n=args.batch_size * 8, size=args.size)
    elif args.shapes:
        from vqvae2_tpu_torch.data.shapes import ShapesDataset

        dataset = ShapesDataset(n=args.shapes, size=args.size, seed=args.seed, raw=True)
    else:
        dataset = ImageFileDataset(args.path, size=args.size, raw=True)
    steps_per_epoch = max(len(dataset) // args.batch_size, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    model = build_vqvae(
        device=device, seed=args.seed, in_channel=3, channel=args.channel,
        n_res_block=args.n_res_block, n_res_channel=args.n_res_channel,
        embed_dim=args.embed_dim, n_embed=args.n_embed,
        restart_threshold=args.restart_threshold,
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    tx = (schedules.cycle_adam(args.lr, total_steps) if args.sched == "cycle"
          else schedules.adam(args.lr))
    state = create_state(model, tx)
    if args.resume and args.ckpt_dir:
        restored, name = CheckpointManager(args.ckpt_dir).restore_latest(map_location=device)
        if name is not None:
            state.load_state_dict(restored)
        if par.is_primary():
            print(f"resumed from {args.ckpt_dir}/{name} at step {state.step}" if name else
                  f"no checkpoint in {args.ckpt_dir}; starting fresh", flush=True)
    par.replicate(state.model)
    train_step = make_train_step(model, tx, grad_accum=args.grad_accum)
    eval_step = make_eval_step(model)

    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    from vqvae2_tpu_torch.utils.metrics import CsvLogger, TensorBoardWriter

    tb = TensorBoardWriter(args.logdir if par.is_primary() else "")
    csv = CsvLogger(args.metrics_csv)

    it = iterate_batches(dataset, args.batch_size, seed=args.seed,
                         epochs=None if args.steps else args.epoch, workers=args.workers)
    metrics_hist: Dict[str, float] = {}
    metrics: Dict[str, torch.Tensor] = {}
    t0 = time.perf_counter()
    n_done = 0
    for imgs, labels, paths in it:
        x = imgs
        if args.grad_accum > 1:
            x = imgs.reshape(args.grad_accum, -1, *imgs.shape[1:])
        state, metrics = train_step(state, x)
        n_done += 1
        if n_done % args.log_every == 0:
            m = par.reduce_dict(metrics)
            if par.is_primary():
                rate = n_done * args.batch_size / (time.perf_counter() - t0)
                print(f"step {n_done}/{total_steps} "
                      f"loss {m['loss']:.4f} mse {m['recon_mse']:.4f} "
                      f"latent {m['latent']:.4f} ({rate:.1f} img/s)", flush=True)
                tb.add_scalars(m, n_done, prefix="train/")
                csv.log(n_done, dict(m, img_per_s=rate))
            metrics_hist = m
        if args.sample_every and n_done % args.sample_every == 0 and par.is_primary():
            dec = eval_step(state, imgs[:8])
            head = normalize_to_unit(imgs[:8]) if imgs.dtype == np.uint8 else imgs[:8]
            grid = np.concatenate([head, dec[:8].float().cpu().numpy()], axis=0)
            save_image(grid, f"{args.sample_dir}/{n_done:05d}.png", nrow=8)
        if ckpt and n_done % (steps_per_epoch * 10) == 0:
            ckpt.save_periodic(state.step, state.state_dict())
        if n_done >= total_steps:
            break

    if ckpt:
        ckpt.save_last(state.state_dict())
    return metrics_hist or par.reduce_dict(metrics)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Stage-1 VQ-VAE-2 trainer (PyTorch/CUDA)")
    p.add_argument("path", nargs="?", default=None, help="image directory")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--epoch", type=int, default=560)
    p.add_argument("--steps", type=int, default=0, help="override total steps")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--sched", type=str, default="", choices=["", "cycle"])
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--n_res_block", type=int, default=2)
    p.add_argument("--n_res_channel", type=int, default=32)
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--n_embed", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--shapes", type=int, default=0, metavar="N",
                   help="train on N in-memory procedural structured images "
                        "(data/shapes.py) instead of an image directory")
    p.add_argument("--restart_threshold", type=float, default=0.0,
                   help="dead-code restart: re-seed codes whose EMA cluster size falls "
                        "below this from batch vectors (0 = off, reference parity)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split the batch into this many sequential microbatches "
                        "(summed gradients, one optimizer update)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/matmul compute (params stay fp32; the "
                        "quantizer distance search stays exact fp32)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--sample_dir", type=str, default="sample")
    p.add_argument("--sample_every", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--workers", type=int, default=4,
                   help="decode thread pool size; 0 = inline")
    p.add_argument("--logdir", type=str, default="",
                   help="TensorBoard scalar logdir (optional)")
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if not args.synthetic and not args.shapes and not args.path:
        raise SystemExit("provide an image directory, --shapes N, or --synthetic")
    return par.launch(train, args, device=args.device)


if __name__ == "__main__":
    main()
