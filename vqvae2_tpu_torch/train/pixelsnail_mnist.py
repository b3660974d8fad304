"""The smallest PixelSNAIL workload (port of
``vqvae2_tpu/train/pixelsnail_mnist.py``): ``PixelSNAIL([28, 28], 256,
channel 128, kernel 5, n_block 2, n_res_block 4)`` trained with the
cross-entropy to predict each image's own 256-level pixel intensities.

Data: MNIST idx files under ``--path`` (``train-images-idx3-ubyte``, or its
``.gz``), read from disk only; without ``--path``, deterministic synthetic
digit-like strokes, the same images as the JAX package's for the same seed.

The attention runs at ``channel // 2 = 64`` over 8 heads, so its heads are 8
wide over 784 positions; on the card the hand-written attention kernels run
it forward and backward.  Dropout comes from a ``torch.Generator`` made anew
each step from ``--seed`` and the step count, and a world of N ranks trains
as in ``train/pixelsnail.py`` (``parallel``).

Run: ``python -m vqvae2_tpu_torch.train.pixelsnail_mnist [flags]``.  The device
defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct
import time
from typing import Dict

import numpy as np
import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.models.pixelsnail import PixelSNAIL, batch_rows
from vqvae2_tpu_torch.train.pixelsnail import finish_step, share_loss, step_generator
from vqvae2_tpu_torch.train.vqvae import TrainState, create_state
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.metrics import CsvLogger

IDX3_MAGIC = 2051


def load_mnist_images(path: str) -> np.ndarray:
    """MNIST idx3 training images ``(N, H, W) uint8`` from the directory
    ``path`` (the file may be gzipped)."""
    for name in ("train-images-idx3-ubyte", "train-images.idx3-ubyte"):
        for ext in ("", ".gz"):
            p = os.path.join(path, name + ext)
            if os.path.exists(p):
                opener = gzip.open if ext else open
                with opener(p, "rb") as f:
                    magic, n, h, w = struct.unpack(">IIII", f.read(16))
                    if magic != IDX3_MAGIC:
                        raise ValueError(f"{p}: bad idx magic {magic}, expected {IDX3_MAGIC}")
                    return np.frombuffer(f.read(), np.uint8).reshape(n, h, w)
    raise FileNotFoundError(f"no MNIST idx files under {path}")


def synthetic_digits(n: int = 512, seed: int = 0) -> np.ndarray:
    """Digit-like blobs: five random strokes on each 28x28 canvas, then a
    small blur; ``(n, 28, 28) uint8``."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    for i in range(n):
        pts = rng.integers(4, 24, size=(6, 2))
        for (y0, x0), (y1, x1) in zip(pts[:-1], pts[1:]):
            steps = max(abs(y1 - y0), abs(x1 - x0), 1)
            ys = np.linspace(y0, y1, steps * 2).astype(int)
            xs = np.linspace(x0, x1, steps * 2).astype(int)
            imgs[i, ys, xs] = rng.integers(128, 256)
        padded = np.pad(imgs[i], 1)
        imgs[i] = (padded[:-2, :-2].astype(np.int32) + padded[1:-1, 1:-1] * 4
                   + padded[2:, 2:]) // 6
    return imgs


def build_model(args) -> PixelSNAIL:
    """The reference's MNIST prior at ``args.channel`` and ``args.dropout``."""
    return PixelSNAIL(shape=(28, 28), n_class=256, channel=args.channel, kernel_size=5,
                      n_block=2, n_res_block=4, res_channel=args.channel,
                      dropout=args.dropout)


def make_train_step(model: PixelSNAIL, tx: schedules.AdamSchedule, seed: int = 0):
    """Returns ``train_step(state, codes) -> (state, metrics)``: ``codes``
    ``(B, 28, 28)`` int, the global batch on the host or the device (this
    rank takes its rows); the metrics are this rank's, 0-dim tensors on the
    device."""
    device = next(model.parameters()).device

    def train_step(state: TrainState, codes: torch.Tensor):
        rows = codes.shape[0]
        start, _ = par.shard_rows(rows)
        local = par.shard_batch(codes).to(device)
        gen = step_generator(seed, state.step, device)
        state.optimizer.zero_grad(set_to_none=True)
        with batch_rows(start, rows):
            logits = model(local, generator=gen)
        ce = share_loss(logits, local, rows)
        return state, finish_step(model, tx, state, logits, local, ce)

    return train_step


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    images = (load_mnist_images(args.path) if args.path
              else synthetic_digits(args.n_synthetic, args.seed))
    steps_per_epoch = max(len(images) // args.batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = build_model(args).to(device)
    tx = schedules.adam(args.lr)
    state = create_state(model, tx)
    par.replicate(state.model)
    train_step = make_train_step(model, tx, seed=args.seed + 1)

    csv = CsvLogger(args.metrics_csv)
    order_rng = np.random.default_rng(args.seed)
    n_done, m, t0 = 0, {}, time.perf_counter()
    while n_done < total_steps:
        order = order_rng.permutation(len(images))
        for s in range(0, len(order) - args.batch + 1, args.batch):
            codes = torch.from_numpy(images[order[s: s + args.batch]].astype(np.int64))
            state, metrics = train_step(state, codes)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if par.is_primary():
                    rate = n_done * args.batch / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} loss {m['loss']:.4f} "
                          f"acc {m['acc']:.4f} ({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if n_done >= total_steps:
                break
        if len(images) < args.batch:
            raise SystemExit(f"{len(images)} images, fewer than --batch {args.batch}")
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="PixelSNAIL on MNIST (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="", help="MNIST idx dir")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epoch", type=int, default=10)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--channel", type=int, default=128)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_synthetic", type=int, default=512)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return par.launch(train, args, device=args.device)


if __name__ == "__main__":
    main()
