"""``ModelAdaptive`` trainer (port of ``vqvae2_tpu/train/adaptive.py``): the
VQ-VAE adaptor with its IR head and the ReID net trained together on
SYSU-MM01.

Per batch, as the JAX package's step:

1. **ReID step** (Adam #1) on the IR view (``modal=2``, batch norms in train
   mode): identity CE + batch-hard triplet + the within-identity feature
   variance (the population variance, as ``jnp.var``).
2. **Generator step** (Adam #2) with the ReID net frozen — its parameters
   take no gradient and its batch norms run in eval mode on the statistics
   step 1 just wrote, while the gradient flows through it into the fake IR
   image: ``forward_ir`` (the statistics kernel on both codebooks), the fake
   IR's identity CE, ``100 * KL`` of the fake's scores toward step 1's real
   scores (written as the JAX package writes it: ``mean(q * (log(max(q,
   1e-12)) - log_softmax(fake)))``), the MSE of the per-identity mean
   features, and recon + 0.25 * latent.

``--sched cycle`` gives the generator the 1-cycle Adam.

Data parallel (``parallel``): a step takes the global P×K batch and each rank
its rows.  The batch norms and the quantizers' EMA take the global batch's
statistics; the triplet, the within-identity variance and the per-identity
mean features run on the global features (``gather_batch``); every other
term is this rank's share of a mean over the rows.  So a world of N ranks
takes the single-process step.  ``run_synthetic`` runs a trainer through
``parallel.launch``; logs, samples and checkpoint files come from the
primary rank.

Run: ``python -m vqvae2_tpu_torch.train.adaptive --synthetic [flags]``.  The
device defaults to ``cuda``; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import losses as L
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData
from vqvae2_tpu_torch.models.adaptive import ModelAdaptive, frozen, mode
from vqvae2_tpu_torch.train.reid import make_synthetic_sysu
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.image import save_image
from vqvae2_tpu_torch.utils.metrics import CsvLogger

LATENT_LOSS_WEIGHT = 0.25


@dataclass
class AdaptiveState:
    """The model, the ReID net's optimizer, the generator's (every other
    parameter), and the number of updates made."""

    step: int
    model: torch.nn.Module
    opt_reid: torch.optim.Optimizer
    opt_gen: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "opt_reid": self.opt_reid.state_dict(),
                "opt_gen": self.opt_gen.state_dict(), "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.opt_reid.load_state_dict(state["opt_reid"])
        self.opt_gen.load_state_dict(state["opt_gen"])
        self.step = int(state["step"])


def split_params(model: torch.nn.Module):
    """``(ReID parameters, generator parameters)``: ``person_id`` and the rest."""
    reid = list(model.person_id.parameters())
    gen = [p for n, p in model.named_parameters() if not n.startswith("person_id.")]
    return reid, gen


def create_state(model: torch.nn.Module, tx_reid: schedules.AdamSchedule,
                 tx_gen: schedules.AdamSchedule) -> AdaptiveState:
    reid, gen = split_params(model)
    return AdaptiveState(step=0, model=model.train(), opt_reid=tx_reid.build(reid),
                         opt_gen=tx_gen.build(gen))


def make_train_step(model: ModelAdaptive, tx_reid: schedules.AdamSchedule,
                    tx_gen: schedules.AdamSchedule, num_pos: int):
    """Returns ``train_step(state, batch) -> (state, (metrics, rgb_fake,
    ir_fake))``; ``batch`` holds the global batch's ``rgb``, ``ir`` ``(B, H,
    W, 3)`` and ``label`` ``(B,)`` (numpy arrays or tensors, host or device),
    of which this rank takes its rows.  The metrics are the global batch's;
    the images this rank's rows'."""
    device = next(model.parameters()).device

    def train_step(state: AdaptiveState, batch: Dict[str, torch.Tensor]):
        rows = batch["label"].shape[0]
        local = par.local_batch(batch, device)
        img1, img2, label = local["rgb"], local["ir"], local["label"].long()
        label_all = torch.as_tensor(batch["label"]).to(device).long()
        n = rows // num_pos
        ce = lambda s, y: par.share_mean(F.cross_entropy(s, y, reduction="none"), rows)  # noqa

        state.opt_reid.zero_grad(set_to_none=True)
        with mode(model.person_id, True):
            feat, score = model.person_id(xIR=img2, modal=2)
        grp = par.gather_batch(feat, rows).reshape(n, num_pos, -1)
        pair_re = L.triplet_loss(grp.reshape(rows, -1), label_all)[0] \
            + grp.var(dim=1, correction=0).mean()
        ce_re = ce(score, label)
        (ce_re + pair_re).backward()
        par.all_reduce_grads(state.opt_reid)
        tx_reid.apply(state.opt_reid, state.step)
        state.opt_reid.step()
        mean_feat, score_real = grp.mean(dim=1).detach(), score.detach()

        state.opt_gen.zero_grad(set_to_none=True)
        rgb_fake, latent, ir_fake = model.adaptor.forward_ir(img1, train=True)
        with frozen(model.person_id), mode(model.person_id, False):
            feat_fake, score_fake, *_ = model.person_id(
                xIR=ir_fake.repeat(1, 1, 1, 3), modal=2, with_feature=True)
        mean_fake = par.gather_batch(feat_fake, rows).reshape(n, num_pos, -1).mean(dim=1)
        loss_id_fake = ce(score_fake, label)
        logp = torch.log_softmax(score_fake, dim=-1)
        q = torch.softmax(score_real, dim=-1)
        loss_kl = 100.0 * par.share_mean(q * (torch.log(torch.clamp(q, min=1e-12)) - logp),
                                         rows)
        feat_loss = torch.mean(torch.square(mean_feat - mean_fake))
        recon = par.share_mean(torch.square(rgb_fake - img1), rows)
        latent = latent * (img1.shape[0] / rows)
        shares = recon + LATENT_LOSS_WEIGHT * latent + loss_id_fake + loss_kl
        (shares + feat_loss).backward()
        par.all_reduce_grads(state.opt_gen)
        tx_gen.apply(state.opt_gen, state.step)
        state.opt_gen.step()
        state.step += 1
        metrics = par.global_metrics(
            {"mse": recon, "latent": latent, "id_fake": loss_id_fake, "kl_fake": loss_kl,
             "loss_gen": shares, "loss_reid": ce_re},
            {"feat": feat_loss, "loss_gen": feat_loss, "loss_reid": pair_re})
        return state, (metrics, rgb_fake.detach(), ir_fake.detach())

    return train_step


def sysu_batch(rows, device) -> Dict[str, torch.Tensor]:
    """A list of ``SYSUData`` items as ``{"rgb", "ir", "label"}`` on ``device``."""
    batch = {"rgb": np.stack([r[0] for r in rows]), "ir": np.stack([r[1] for r in rows]),
             "label": np.asarray([r[2] for r in rows], np.int32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def build_model(args, num_class: int, device, **kw) -> torch.nn.Module:
    """``ModelAdaptive(class_num, arch)`` with weights drawn from ``--seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return ModelAdaptive(class_num=num_class, arch=args.arch, **kw).to(device)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=False, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // loader_batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch

    model = build_model(args, dataset.num_class, device)
    tx_reid = schedules.adam(args.lr)
    tx_gen = (schedules.cycle_adam(args.lr, total_steps) if args.sched == "cycle"
              else schedules.adam(args.lr))
    state = create_state(model, tx_reid, tx_gen)
    par.replicate(state.model)
    step_fn = make_train_step(model, tx_reid, tx_gen, args.num_pos)

    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    n_done, m, t0 = 0, {}, time.perf_counter()
    while n_done < total_steps:
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            batch = sysu_batch(rows, "cpu")          # the global batch, on the host
            state, (metrics, rgb_fake, ir_fake) = step_fn(state, batch)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if primary:
                    rate = n_done * loader_batch / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} mse {m['mse']:.5f} "
                          f"lat {m['latent']:.3f} id_fake {m['id_fake']:.3f} "
                          f"reid {m['loss_reid']:.3f} ({rate:.1f} img/s)", flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if args.sample_every and n_done % args.sample_every == 0 and primary:
                # sample grid: rgb | fake rgb | real ir | fake ir (the primary's rows)
                k = min(8, rgb_fake.shape[0])
                host = lambda t: t[:k].cpu().numpy()    # noqa: E731
                grid = np.concatenate([host(batch["rgb"]), host(rgb_fake), host(batch["ir"]),
                                       np.repeat(host(ir_fake), 3, -1)], axis=0)
                save_image(grid, f"{args.sample_dir}/{n_done:05d}.png", nrow=k,
                           value_range=(-2.0, 2.0))
            if ckpt and n_done % (steps_per_epoch * 10) == 0:
                ckpt.save_periodic(n_done, state.state_dict())
            if n_done >= total_steps:
                break
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="ModelAdaptive (VQ-VAE + ReID) trainer "
                                            "(PyTorch/CUDA)")
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
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--sample_dir", type=str, default="sample")
    p.add_argument("--sample_every", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def run_synthetic(train_fn, args, hw=(96, 48)):
    """``train_fn(args)`` on ``--path``, or on a synthetic SYSU tree of
    ``hw`` (96x48) images with ``--synthetic``, through ``parallel.launch``
    (each rank writes the same tree from the same seed)."""
    resolve_device(args.device)
    return par.launch(_on_path, train_fn, args, hw, device=args.device)


def _on_path(train_fn, args, hw):
    if not args.synthetic:
        return train_fn(args)
    with tempfile.TemporaryDirectory(prefix="sysu_syn_") as tmp:
        args.path = make_synthetic_sysu(tmp, h=hw[0], w=hw[1])
        return train_fn(args)


def main(argv=None):
    return run_synthetic(train, build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
