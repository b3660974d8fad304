"""Stage-2 PixelSNAIL prior trainer over extracted codes (port of
``vqvae2_tpu/train/pixelsnail.py``): cross-entropy over the 512-way codebook on
fp32 logits, accuracy beside it; ``--hier top`` is the unconditional attention
prior over the top grid, ``--hier bottom`` the attention-free prior over the
bottom grid conditioned on the top codes; Adam at lr 3e-4 or the 1-cycle lr
(``--sched cycle``, β₁ left at 0.9).

Dropout is drawn from a ``torch.Generator`` made anew each step from ``--seed``
and the step count, the counterpart of ``jax.random.fold_in(rng, state.step)``:
a step is repeatable, and a resumed run draws what the uninterrupted one would
have.  On the card the top prior's attention runs forward and backward through
the hand-written kernels, dropout on the probabilities included.

Weights carried across from the JAX package (``pixelsnail_from_jax``) and a
fresh Adam state on both sides are how the two trainers are held against each
other: no map of the optimizer state is needed.

``--bf16`` builds the prior with ``dtype=torch.bfloat16``: bf16 convolutions,
fp32 parameters, attention in fp32 (as the JAX package's promotion has it),
logits widened to fp32 before the loss.

Data parallel (``parallel``), as in ``train/vqvae.py``: a step takes the global
batch, each rank its rows and its share of the loss, and the gradients are
summed over the ranks.  Every rank makes the same step generator; the
residual blocks' dropout draws the global batch's masks and keeps the rank's
rows (``models.pixelsnail.batch_rows``), and the attention kernels offset
their seed by the rank, as the JAX package's do a shard's.  With attention
dropout at 0 a world of N ranks takes the single-process step.

Run: ``python -m vqvae2_tpu_torch.train.pixelsnail codes.vq2 --hier top
[flags]``.  The device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.codestore import CodeStore
from vqvae2_tpu_torch.models.pixelsnail import PixelSNAIL, batch_rows
from vqvae2_tpu_torch.train.vqvae import TrainState, create_state
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager


def build_model(hier: str, args, code_hw=(32, 64)) -> PixelSNAIL:
    """The top or bottom prior for code grids ``code_hw = (top, bottom)``.

    ``hier == "top"``: the unconditional attention prior over the top grid;
    anything else: the attention-free bottom prior conditioned on the top
    codes.  ``args`` carries ``n_class``, ``channel``, ``n_res_block``,
    ``n_res_channel``, ``dropout``, and ``n_out_res_block`` (top) or
    ``n_cond_res_block`` (bottom); ``args.bf16`` selects bf16 compute (fp32
    parameters)."""
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else torch.float32
    top_hw, bot_hw = code_hw
    if hier == "top":
        return PixelSNAIL(
            shape=(top_hw, top_hw), n_class=args.n_class, channel=args.channel,
            kernel_size=5, n_block=4, n_res_block=args.n_res_block,
            res_channel=args.n_res_channel, dropout=args.dropout,
            n_out_res_block=args.n_out_res_block, dtype=dtype,
        )
    return PixelSNAIL(
        shape=(bot_hw, bot_hw), n_class=args.n_class, channel=args.channel,
        kernel_size=5, n_block=4, n_res_block=args.n_res_block,
        res_channel=args.n_res_channel, attention=False, dropout=args.dropout,
        n_cond_res_block=args.n_cond_res_block,
        cond_res_channel=args.n_res_channel, dtype=dtype,
    )


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of one step: a generator on ``device`` seeded from
    ``(seed, step)`` alone."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def make_train_step(model: PixelSNAIL, tx: schedules.AdamSchedule, conditional: bool,
                    seed: int = 0):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds the global batch's ``"target"`` codes ``(B, H, W)`` and, for a
    conditional prior, ``"condition"`` ``(B, H/2, W/2)`` (tensors on the host
    or the device; this rank takes its rows and moves them to the model's
    device).  The step's dropout comes from ``step_generator(seed,
    state.step)``.  The metrics are this rank's, 0-dim tensors on the
    device."""
    device = next(model.parameters()).device

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        rows = batch["target"].shape[0]
        start, _ = par.shard_rows(rows)
        local = {k: v.to(device) for k, v in par.shard_batch(batch).items()}
        codes = local["target"]
        gen = step_generator(seed, state.step, device)
        state.optimizer.zero_grad(set_to_none=True)
        with batch_rows(start, rows):
            logits = model(codes, condition=local["condition"] if conditional else None,
                           generator=gen)
        ce = share_loss(logits, codes, rows)
        return state, finish_step(model, tx, state, logits, codes, ce)

    return train_step


def share_loss(logits: torch.Tensor, codes: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's cross-entropy (fp32 logits), backpropagated as its share
    of the mean over the global batch's ``rows`` rows; returned unscaled."""
    if codes.shape[0] == 0:      # no rows here: a zero loss that still reaches every weight
        ce = logits.sum().to(torch.float32)
    else:
        ce = F.cross_entropy(logits.to(torch.float32).reshape(-1, logits.shape[-1]),
                             codes.reshape(-1).long())
    (ce * (codes.shape[0] / rows)).backward()
    return ce.detach()


def finish_step(model, tx: schedules.AdamSchedule, state: TrainState, logits: torch.Tensor,
                codes: torch.Tensor, ce: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sum the gradients over the ranks, take the optimizer step; the metrics."""
    par.all_reduce_grads(model.parameters())
    tx.apply(state.optimizer, state.step)
    state.optimizer.step()
    state.step += 1
    acc = par.local_mean((logits.detach().argmax(-1) == codes.long()).to(torch.float32))
    return {"loss": ce, "acc": acc}


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    store = CodeStore(args.path)
    th, tw = store.top_shape
    bh, bw = store.bot_shape
    steps_per_epoch = max(len(store) // args.batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    conditional = args.hier == "bottom"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = build_model(args.hier, args, code_hw=(th, bh)).to(device)
    tx = (schedules.cycle_adam(args.lr, total_steps, momentum=None) if args.sched == "cycle"
          else schedules.adam(args.lr))
    state = create_state(model, tx)
    train_step = make_train_step(model, tx, conditional, seed=args.seed + 1)

    from vqvae2_tpu_torch.utils.metrics import CsvLogger

    csv = CsvLogger(args.metrics_csv)
    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    if ckpt and args.resume:
        restored, name = ckpt.restore_latest(map_location=device)
        if name is not None:
            state.load_state_dict(restored)
        if par.is_primary():
            print(f"resumed from {args.ckpt_dir}/{name} at step {state.step}" if name else
                  f"no checkpoint in {args.ckpt_dir}; starting fresh", flush=True)
    par.replicate(state.model)

    order_rng = np.random.default_rng(args.seed)
    t0, n_done = time.perf_counter(), 0
    m: Dict[str, float] = {}
    metrics: Optional[Dict[str, torch.Tensor]] = None
    while n_done < total_steps:
        order = order_rng.permutation(len(store))
        for s in range(0, len(order) - args.batch + 1, args.batch):
            tops, bots, _ = store.gather(order[s: s + args.batch])
            if conditional:
                batch = {"target": torch.from_numpy(bots.astype(np.int64)),
                         "condition": torch.from_numpy(tops.astype(np.int64))}
            else:
                batch = {"target": torch.from_numpy(tops.astype(np.int64))}
            state, metrics = train_step(state, batch)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if par.is_primary():
                    rate = n_done * args.batch / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} loss {m['loss']:.5f} "
                          f"acc {m['acc']:.5f} ({rate:.1f} codes-rows/s)", flush=True)
                    csv.log(n_done, dict(m, rows_per_s=rate))
            if ckpt and n_done % (steps_per_epoch * 10) == 0:
                ckpt.save_periodic(state.step, state.state_dict())
            if n_done >= total_steps:
                break
        if len(store) < args.batch:
            raise SystemExit(f"the code store holds {len(store)} rows, fewer than "
                             f"--batch {args.batch}")
    store.close()
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m or par.reduce_dict(metrics or {})


def build_argparser():
    p = argparse.ArgumentParser(description="Stage-2 PixelSNAIL prior trainer (PyTorch/CUDA)")
    p.add_argument("path", help="code store file (.vq2)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--epoch", type=int, default=420)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--hier", type=str, default="top", choices=["top", "bottom"])
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--n_class", type=int, default=512)
    p.add_argument("--channel", type=int, default=256)
    p.add_argument("--n_res_block", type=int, default=4)
    p.add_argument("--n_res_channel", type=int, default=256)
    p.add_argument("--n_out_res_block", type=int, default=0)
    p.add_argument("--n_cond_res_block", type=int, default=3)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv/matmul compute (fp32 params, fp32 logits and loss)")
    p.add_argument("--sched", type=str, default="")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
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
