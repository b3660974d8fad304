"""StarGAN-v2 bidirectional trainer (port of
``vqvae2_tpu/train/stargan_bi.py``): the bi cycle on StarGAN-v2 generators
with an image-level two-domain discriminator, adversarial BCE and the R1
zero-centred gradient penalty.

Per batch, as the JAX package's step (the host side as
``train/vqvae_deep_bi.py``'s: the gray mix, then :func:`aug_transforms` of
both views):

1. **ReID step** (Nesterov SGD, no decay, no schedule), batch norms in train
   mode: identity CE + weighted-regularisation triplets per modality on the
   augmented views; its features are the styles of the next step.
2. **Generator step** (Adam over the mapping network and both generators):
   gray -> IR (``gen_1``), IR -> gray (``gen_2``) and both cycles, the cycle
   MSE against the channel means, half of the translations' identity CE and
   of the center-margin hinge over L2-normalised features, and
   ``adv_weight`` times the BCE of the discriminator's ``1 - y`` heads on
   the translations toward "real".  The ReID net runs frozen but in **train
   mode** (batch statistics, as the reference keeps the model in train mode
   there); the running statistics that pass moves are put back, as the JAX
   package discards them.  The discriminator runs frozen.
3. **Discriminator step** (Adam) on the detached translations: BCE of the
   real images' luminance (channel mean x3) toward 1 on heads ``y``, of the
   translations toward 0 on heads ``1 - y``, and ``r1_weight`` times R1 =
   0.5 E[|dD/dx|^2] on the real inputs, a gradient of a gradient
   (``torch.autograd.grad(..., create_graph=True)``) whose own gradient
   reaches D's parameters.  On a step that ``--d_every`` masks, D's
   parameters and its Adam state stay as they were.

``--eval_every N`` measures the identity-preservation mAP (gray probes
translated to IR with another IR image's style, ranked by the frozen ReID
net against real IR galleries, averaged over ``--idpres_trials`` draws) and
keeps the best checkpoint by it.

Data parallel (``parallel``): every rank draws the global batch's
augmentations and takes its rows.  The ReID net's batch norms take the
global batch's moments (in the generator step too, whose running statistics
are put back on every rank alike); the triplets and the center-margin hinge
run on the global features (``gather_batch``); the BCEs, the identity CE,
the cycle and R1 (a sum per row) are this rank's share of a mean over the
rows.  Each of the three optimizers steps on the gradients summed over the
ranks, and ``--d_every`` masks the same steps on every rank.  So a world of N
ranks takes the single-process step.  ``main`` runs ``train`` through
``parallel.launch``; logs, samples, the identity-preservation evaluation and
checkpoint files come from the primary rank.

Run: ``python -m vqvae2_tpu_torch.train.stargan_bi --synthetic [flags]``
(``--synthetic``: a 64x64 tree).  The device defaults to ``cuda``; ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import losses as L
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch import resolve_device, set_reference_precision
from vqvae2_tpu_torch.data.datasets import epoch_row_batches
from vqvae2_tpu_torch.data.sysu import SYSUData, imagenet_normalize
from vqvae2_tpu_torch.models.adaptive import frozen, mode
from vqvae2_tpu_torch.models.stargan import ModelStarGAN
from vqvae2_tpu_torch.train.adaptive import run_synthetic
from vqvae2_tpu_torch.train.vqvae_deep_bi import _e3, cross_modal_batch
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager
from vqvae2_tpu_torch.utils.image import save_image
from vqvae2_tpu_torch.utils.metrics import CsvLogger


def adv_loss(logits: torch.Tensor, target: int, reduction: str = "mean") -> torch.Tensor:
    """BCE with logits against a constant target."""
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, float(target)),
                                              reduction=reduction)


def _generator_img_size(h: int, w: int) -> int:
    """The largest ``img_size`` whose hourglass divides (h, w) exactly: the
    generator with ``w_hpf=1`` runs ``log2(img_size) - 3`` stride-2 stages.
    At 288x144 this is 128."""
    twos = min((h & -h).bit_length(), (w & -w).bit_length()) - 1
    return min(1 << int(np.log2(max(h, w))), 1 << (twos + 3))


@dataclass
class GanState:
    """The model, the three optimizers and the number of updates made."""

    step: int
    model: ModelStarGAN
    opt_reid: torch.optim.Optimizer
    opt_gen: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "opt_reid": self.opt_reid.state_dict(),
                "opt_gen": self.opt_gen.state_dict(), "opt_disc": self.opt_disc.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        for name in ("opt_reid", "opt_gen", "opt_disc"):
            getattr(self, name).load_state_dict(state[name])
        self.step = int(state["step"])


def _split(model: ModelStarGAN):
    """``(ReID, generator, discriminator)`` parameters: ``person_id``, every
    other module, ``discriminator``."""
    gen = [p for n, p in model.named_parameters()
           if not n.startswith(("person_id.", "discriminator."))]
    return list(model.person_id.parameters()), gen, list(model.discriminator.parameters())


def create_state(model: ModelStarGAN, tx_reid: schedules.SGDSchedule,
                 tx_gen: schedules.AdamSchedule, tx_disc: schedules.AdamSchedule) -> GanState:
    reid, gen, disc = _split(model)
    return GanState(step=0, model=model.train(), opt_reid=tx_reid.build(reid),
                    opt_gen=tx_gen.build(gen), opt_disc=tx_disc.build(disc))


@contextlib.contextmanager
def statistics_discarded(module: torch.nn.Module):
    """The running statistics that a train-mode pass in the block moves are
    put back as they were after it."""
    saved = [(b, b.detach().clone()) for b in module.buffers()]
    try:
        yield module
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


def _lum(x: torch.Tensor) -> torch.Tensor:
    """Channel mean x3: the luminance space the discriminator judges."""
    return torch.mean(x, dim=-1, keepdim=True).repeat(1, 1, 1, 3)


def _l2n(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)


def _domains(bs: int, device) -> torch.Tensor:
    """``y``: 1 for the gray half, 0 for the IR half."""
    return torch.cat([torch.ones(bs, dtype=torch.int64, device=device),
                      torch.zeros(bs, dtype=torch.int64, device=device)])


def make_loss_fns(model: ModelStarGAN, num_pos: int):
    """The three objectives: ``reid_loss(batch, label_all, metrics)``,
    ``gen_loss(batch, featV, featI, adv_weight, label_all)`` and
    ``disc_loss(gray, ir, g2i, i2g, r1_weight, create_graph, rows)``; each
    runs its forward on this rank's rows of a global batch (``label_all``
    its labels, ``batch``'s own without a group) and returns what this rank
    backpropagates with what the step needs: its share of the terms per row
    and the terms over identities whole, on the global features.  The metrics
    are the global batch's (``reid_loss`` writes its into ``metrics`` when
    given).  No parameter is frozen and no optimizer runs here."""

    def reid_loss(batch, label_all=None, metrics=None):
        label = batch["label"].long()
        label_all = label if label_all is None else label_all
        rows = label_all.shape[0]
        with mode(model.person_id, True):
            feat, score, *_ = model.person_id(xRGB=batch["aug_rgb"], xIR=batch["aug_ir"],
                                              modal=0, with_feature=True)
        fv, fi = (par.gather_batch(f, rows) for f in torch.chunk(feat, 2, dim=0))
        ce = par.share_mean(F.cross_entropy(score, torch.cat([label, label]), reduction="none"),
                            2 * rows)
        pair = L.triplet_loss_wrt(fv, label_all)[0] + L.triplet_loss_wrt(fi, label_all)[0]
        if metrics is not None:
            metrics.update(par.global_metrics({"loss_reid": ce}, {"loss_reid": pair}))
        return ce + pair, feat

    def gen_loss(batch, featV, featI, adv_weight: float, label_all=None):
        gray, ir, label = batch["gray"], batch["ir"], batch["label"].long()
        label_all = label if label_all is None else label_all
        bs, rows = gray.shape[0], label_all.shape[0]
        mse = lambda a, b: par.share_mean(torch.square(a - b), rows)     # noqa: E731
        g2i = _e3(model.gen_1(gray, featI))
        i2g = _e3(model.gen_2(ir, featV))
        g2i2g = _e3(model.gen_2(g2i, featV))
        i2g2i = _e3(model.gen_1(i2g, featI))
        # train mode, as the reference keeps the model in train mode here:
        # batch statistics renormalise the fresh generator's fakes; the
        # running statistics this pass moves are put back
        with statistics_discarded(model.person_id), mode(model.person_id, True):
            fake_feat, fake_score, *_ = model.person_id(xRGB=i2g, xIR=g2i, modal=0,
                                                        with_feature=True)
        # the heads 1 - y on which the discriminator scores fakes
        d_fake = model.discriminate(torch.cat([g2i, i2g], dim=0),
                                    1 - _domains(bs, gray.device))
        cycle = (mse(i2g2i, torch.mean(ir, dim=-1, keepdim=True).repeat(1, 1, 1, 3))
                 + mse(g2i2g, torch.mean(gray, dim=-1, keepdim=True).repeat(1, 1, 1, 3)))
        loss_id_ir = par.share_mean(F.cross_entropy(fake_score, torch.cat([label, label]),
                                                    reduction="none"), 2 * rows)
        fv, fi = (par.gather_batch(f, rows) for f in torch.chunk(_l2n(fake_feat), 2, dim=0))
        n = rows // num_pos
        center = lambda f: f.reshape(n, num_pos, -1).mean(dim=1)     # noqa: E731
        pos = torch.mean(torch.square(center(fv) - center(fi)), dim=1)
        real_v, real_i = (par.gather_batch(_l2n(f), rows) for f in (featV, featI))
        neg = torch.mean(torch.square(center(real_v) - center(real_i)), dim=1)
        feat_ir = torch.mean(torch.clamp(0.01 + pos - neg, min=0.0))
        g_adv = par.share_mean(adv_loss(d_fake, 1, reduction="none"), 2 * rows)
        shares = cycle + 0.5 * loss_id_ir + adv_weight * g_adv
        metrics = par.global_metrics(
            {"cycle": cycle, "id_ir": loss_id_ir, "g_adv": g_adv, "loss_gen": shares},
            {"feat_ir": feat_ir, "hinge_pos": torch.mean(pos), "hinge_neg": torch.mean(neg),
             "loss_gen": 0.5 * feat_ir})
        return shares + 0.5 * feat_ir, metrics, g2i, i2g

    def disc_loss(gray, ir, g2i, i2g, r1_weight: float, create_graph: bool = True,
                  rows: Optional[int] = None):
        bs = gray.shape[0]
        rows = bs if rows is None else rows
        y = _domains(bs, gray.device)
        x_real = torch.cat([_lum(gray), _lum(ir)], dim=0).requires_grad_(True)
        out_real = model.discriminate(x_real, y)
        loss_real = par.share_mean(adv_loss(out_real, 1, reduction="none"), 2 * rows)
        # R1 = 0.5 E[|grad_x D(x)|^2]; with create_graph its gradient
        # reaches D's parameters
        grad_x, = torch.autograd.grad(out_real.sum(), x_real, create_graph=create_graph,
                                      retain_graph=True)
        r1 = 0.5 * par.share_mean(torch.sum(torch.square(grad_x.reshape(2 * bs, -1)), dim=1),
                                  2 * rows)
        out_fake = model.discriminate(torch.cat([g2i, i2g], dim=0), 1 - y)
        loss_fake = par.share_mean(adv_loss(out_fake, 0, reduction="none"), 2 * rows)
        return loss_real + loss_fake + r1_weight * r1, (loss_real, loss_fake, r1)

    return reid_loss, gen_loss, disc_loss


def make_train_step(model: ModelStarGAN, tx_reid: schedules.SGDSchedule,
                    tx_gen: schedules.AdamSchedule, tx_disc: schedules.AdamSchedule,
                    num_pos: int):
    """Returns ``train_step(state, batch, knobs=None) -> (state, metrics)``;
    ``batch`` is the global batch (numpy arrays or tensors, host or device),
    of which this rank takes its rows; ``knobs`` may set ``r1_weight`` (1.0),
    ``adv_weight`` (0.5) and ``d_mask`` (1.0: the discriminator takes its
    step).  The metrics are the global batch's."""
    reid_loss, gen_loss, disc_loss = make_loss_fns(model, num_pos)
    device = next(model.parameters()).device

    def train_step(state: GanState, batch: Dict[str, torch.Tensor],
                   knobs: Optional[Dict[str, float]] = None):
        kn = knobs or {}
        r1_weight = float(kn.get("r1_weight", 1.0))
        adv_weight = float(kn.get("adv_weight", 0.5))
        update_d = float(kn.get("d_mask", 1.0)) > 0
        label_all = torch.as_tensor(batch["label"]).to(device).long()
        rows = label_all.shape[0]
        batch = par.local_batch(batch, device)

        state.opt_reid.zero_grad(set_to_none=True)
        m_re: Dict[str, torch.Tensor] = {}
        loss_re, feat = reid_loss(batch, label_all, m_re)
        loss_re.backward()
        par.all_reduce_grads(state.opt_reid)
        schedules.fill_missing_grads(state.opt_reid)
        tx_reid.apply(state.opt_reid, state.step)
        state.opt_reid.step()
        featV, featI = torch.chunk(feat.detach(), 2, dim=0)

        state.opt_gen.zero_grad(set_to_none=True)
        # the backward recomputes the frozen discriminator (remat): it runs
        # inside the block, as the forward did
        with frozen(model.person_id), frozen(model.discriminator):
            loss_g, metrics, g2i, i2g = gen_loss(batch, featV, featI, adv_weight, label_all)
            loss_g.backward()
        par.all_reduce_grads(state.opt_gen)
        schedules.fill_missing_grads(state.opt_gen)
        tx_gen.apply(state.opt_gen, state.step)
        state.opt_gen.step()

        state.opt_disc.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss_d, (d_real, d_fake, r1) = disc_loss(batch["gray"], batch["ir"], g2i.detach(),
                                                     i2g.detach(), r1_weight, update_d, rows)
        if update_d:            # the same on every rank: the knob comes from the step count
            loss_d.backward()
            par.all_reduce_grads(state.opt_disc)
            schedules.fill_missing_grads(state.opt_disc)
            tx_disc.apply(state.opt_disc, state.step)
            state.opt_disc.step()
        state.step += 1
        disc = par.global_metrics({"loss_disc": loss_d, "d_real": d_real, "d_fake": d_fake,
                                   "r1": r1})
        return state, {**metrics, **m_re, **disc}

    return train_step


def build_idpres_set(dataset: SYSUData, max_ids: int = 32, seed: int = 0, trials: int = 5):
    """Probe sets of the identity-preservation metric: per identity one gray
    query source (instance a), one style-donor IR image (b) and one gallery
    IR image (c != b), ImageNet-normalised; ``trials`` independent draws of
    ``(grays, styles, galleries, labels)``."""
    rng = np.random.default_rng(seed)
    ids = np.unique(dataset.train_color_label)[:max_ids]
    out = []
    for _ in range(max(trials, 1)):
        grays, styles, gals, labels = [], [], [], []
        for pid in ids:
            ci = np.flatnonzero(dataset.train_color_label == pid)
            ti = np.flatnonzero(dataset.train_ir_label == pid)
            if len(ci) == 0 or len(ti) == 0:
                continue
            a = rng.choice(ci)
            b, c = (rng.choice(ti, size=2, replace=False) if len(ti) >= 2 else (ti[0], ti[0]))
            rgb = imagenet_normalize(dataset.train_color_image[a])
            grays.append(np.repeat(rgb.mean(axis=-1, keepdims=True), 3, axis=-1))
            styles.append(imagenet_normalize(dataset.train_ir_image[b]))
            gals.append(imagenet_normalize(dataset.train_ir_image[c]))
            labels.append(pid)
        out.append((np.stack(grays).astype(np.float32), np.stack(styles).astype(np.float32),
                    np.stack(gals).astype(np.float32), np.asarray(labels, np.int64)))
    return out


def make_idpres_eval(model: ModelStarGAN):
    """``evaluate(probe_sets) -> mAP``: the gray probes translated to IR with
    the style of another IR image of their identity, their L2-normalised
    IR-path features from the ReID net in eval mode ranked against the real
    IR galleries', averaged over the draws.  Nothing of the model moves."""
    from vqvae2_tpu_torch.eval.reid import cosine_distmat, eval_sysu

    device = next(model.parameters()).device

    @torch.no_grad()
    def feats(gray_q, ir_style, ir_gal):
        with mode(model.person_id, False):
            style = model.person_id(xIR=ir_style, modal=2, with_feature=True)[0]
            g2i = _e3(model.gen_1(gray_q, style))
            qf = model.person_id(xIR=g2i, modal=2)[1]
            gf = model.person_id(xIR=ir_gal, modal=2)[1]
        return qf.float().cpu().numpy(), gf.float().cpu().numpy()

    def evaluate(probe_sets: List) -> float:
        maps = []
        for gray_q, ir_style, ir_gal, labels in probe_sets:
            qf, gf = feats(*(torch.from_numpy(a).to(device) for a in (gray_q, ir_style, ir_gal)))
            _, mAP, _ = eval_sysu(cosine_distmat(qf, gf), labels, labels)
            maps.append(mAP)
        return float(np.mean(maps))

    return evaluate


def make_sample_fn(model: ModelStarGAN):
    """An eval-mode translation pass: ``sample(batch) -> (gray -> IR, IR ->
    gray)`` with the styles of the un-augmented pair; nothing moves."""

    @torch.no_grad()
    def sample(batch: Dict[str, torch.Tensor]):
        with mode(model.person_id, False):
            feat = model.person_id(xRGB=batch["gray"], xIR=batch["ir"], modal=0,
                                   with_feature=True)[0]
        fv, fi = torch.chunk(feat, 2, dim=0)
        return _e3(model.gen_1(batch["gray"], fi)), _e3(model.gen_2(batch["ir"], fv))

    return sample


def dump_samples(sample_fn, batch: Dict[str, torch.Tensor], path: str,
                 max_rows: int = 8) -> None:
    """Grid rows [gray input, gray -> IR, real IR, IR -> gray]."""
    g2i, i2g = sample_fn(batch)
    k = min(int(batch["ir"].shape[0]), max_rows)
    take = lambda t: t[:k].float().cpu().numpy()            # noqa: E731
    grid = np.concatenate([take(batch["gray"]), take(g2i), take(batch["ir"]), take(i2g)],
                          axis=0)
    save_image(grid, path, nrow=k)


def build_model(args, num_class: int, hw, device) -> ModelStarGAN:
    """``ModelStarGAN`` for ``hw`` images with weights drawn from ``--seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        return ModelStarGAN(class_num=num_class, arch=args.arch,
                            img_size=_generator_img_size(*hw)).to(device)


def train(args) -> Dict[str, float]:
    device = resolve_device(args.device)
    set_reference_precision()
    dataset = SYSUData(args.path, part=False, seed=args.seed)
    loader_batch = args.batch_size * args.num_pos
    steps_per_epoch = max(len(dataset) // loader_batch, 1)
    total_steps = args.steps or steps_per_epoch * args.epoch
    h, w = dataset.train_color_image.shape[1:3]

    model = build_model(args, dataset.num_class, (h, w), device)
    tx_reid = schedules.SGDSchedule(args.lr_F, momentum=0.9, nesterov=True)
    tx_gen, tx_disc = schedules.adam(args.lr), schedules.adam(args.lr_disc)
    state = create_state(model, tx_reid, tx_gen, tx_disc)
    if args.resume and args.ckpt_dir:
        restored, name = CheckpointManager(args.ckpt_dir).restore_latest(map_location=device)
        if name:
            state.load_state_dict(restored)
        if par.is_primary():
            print(f"resumed from {args.ckpt_dir}/{name}" if name else
                  f"no checkpoint in {args.ckpt_dir}; starting fresh", flush=True)
    par.replicate(state.model)
    ckpt = CheckpointManager(args.ckpt_dir, config=vars(args)) if args.ckpt_dir else None
    step_fn = make_train_step(model, tx_reid, tx_gen, tx_disc, args.num_pos)
    sample_fn = make_sample_fn(model) if args.sample_dir else None
    idpres = ((make_idpres_eval(model),
               build_idpres_set(dataset, seed=args.seed, trials=args.idpres_trials))
              if args.eval_every else None)
    host_rng = np.random.default_rng(args.seed)

    primary = par.is_primary()
    csv = CsvLogger(args.metrics_csv if primary else "")
    map_csv = CsvLogger(args.map_csv if primary else "")
    n_done, m, t0 = 0, {}, time.perf_counter()
    while n_done < total_steps:
        dataset.samplize(args.batch_size, args.num_pos)
        for rows in epoch_row_batches(dataset, loader_batch):
            batch = cross_modal_batch(rows, host_rng, "cpu")   # the global batch
            knobs = {"r1_weight": args.r1_weight, "adv_weight": args.adv_weight,
                     "d_mask": 1.0 if n_done % args.d_every == 0 else 0.0}
            state, metrics = step_fn(state, batch, knobs)
            n_done += 1
            if n_done % args.log_every == 0:
                m = par.reduce_dict(metrics)
                if primary:
                    rate = n_done * loader_batch / (time.perf_counter() - t0)
                    print(f"step {n_done}/{total_steps} gen {m['loss_gen']:.3f} "
                          f"disc {m['loss_disc']:.3f} reid {m['loss_reid']:.3f} "
                          f"cycle {m['cycle']:.4f} r1 {m['r1']:.4f} ({rate:.1f} img/s)",
                          flush=True)
                    csv.log(n_done, dict(m, img_per_s=rate))
            if sample_fn is not None and n_done % args.sample_every == 0 and primary:
                dump_samples(sample_fn, {k: v.to(device) for k, v in batch.items()},
                             f"{args.sample_dir}/{n_done:05d}.png")
            if idpres is not None and n_done % args.eval_every == 0:
                # on the primary rank, the ReID net and the generators in eval mode
                mAP = par.from_primary(idpres[0](idpres[1]) if primary else 0.0, device)
                m["idpres_map"] = mAP
                map_csv.log(n_done, {"idpres_map": mAP})
                if primary:
                    print(f"step {n_done}: identity-preservation mAP {mAP:.4f}", flush=True)
                if ckpt and ckpt.save_best(mAP, state.state_dict()) and primary:
                    print(f"step {n_done}: new best idpres mAP {mAP:.4f}", flush=True)
            if ckpt and args.save_every and n_done % args.save_every == 0:
                ckpt.save_periodic(n_done, state.state_dict())
            if n_done >= total_steps:
                break
    if ckpt:
        ckpt.save_last(state.state_dict())
    return m


def build_argparser():
    p = argparse.ArgumentParser(description="StarGAN-v2 bidirectional trainer (PyTorch/CUDA)")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_pos", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_disc", type=float, default=1e-4)
    p.add_argument("--lr_F", type=float, default=0.1)
    p.add_argument("--arch", type=str, default="resnet18")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--sample_dir", type=str, default="",
                   help="dump [gray, gray->IR, IR, IR->gray] grids here")
    p.add_argument("--sample_every", type=int, default=500)
    p.add_argument("--metrics_csv", type=str, default="",
                   help="append per-log-step scalars to this CSV (loss curves)")
    p.add_argument("--r1_weight", type=float, default=1.0,
                   help="R1 gradient-penalty weight")
    p.add_argument("--adv_weight", type=float, default=0.5,
                   help="generator adversarial-loss weight (reference: 0.5)")
    p.add_argument("--d_every", type=int, default=1,
                   help="update the discriminator every N steps (lazy-D)")
    p.add_argument("--eval_every", type=int, default=0,
                   help="compute frozen-reid identity-preservation mAP every N steps")
    p.add_argument("--idpres_trials", type=int, default=5,
                   help="independent probe/gallery draws averaged per idpres eval")
    p.add_argument("--ckpt_dir", type=str, default="",
                   help="periodic/last/best-idpres checkpoints (off if empty)")
    p.add_argument("--save_every", type=int, default=0,
                   help="periodic checkpoint cadence in steps (0 = last/best only)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest step_*/last checkpoint from --ckpt_dir")
    p.add_argument("--map_csv", type=str, default="",
                   help="append (step, idpres_map) rows to this CSV")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on; the CPU only when asked for")
    return p


def main(argv=None):
    return run_synthetic(train, build_argparser().parse_args(argv), hw=(64, 64))


if __name__ == "__main__":
    main()
