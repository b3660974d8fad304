"""Rank functions and the world harness of the port's multi-process tests
(``tests/test_torch_parallel*.py``).

``run_world`` starts ``world`` processes by the ``spawn`` method (never
``fork``: the test process has started JAX's threads), each of which forms a
``gloo`` group over a ``file://`` store under the test's temporary directory
(no port that parallel test workers could share), runs ``jobs`` — names of
functions of this module with their arguments — and saves their results.
Every child is joined with a timeout, so a hang fails in seconds.

This module imports torch, numpy and the port only: the JAX references are
computed in the test process and the children never import JAX.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import sys
import time
import traceback

import numpy as np
import torch

JOIN_TIMEOUT = 180.0            # seconds for a whole world, start-up included


def run_world(world: int, tmp_path, jobs, timeout: float = JOIN_TIMEOUT):
    """``[rank's results]``: each rank's list of ``fn(rank, world, *args)``
    for ``(fn_name, args)`` in ``jobs``, in order."""
    return join_world(start_world(world, tmp_path, jobs), timeout)


def run_worlds(sizes, tmp_path_factory, jobs, meanwhile=None, timeout: float = JOIN_TIMEOUT):
    """``{world: results}`` of a world of each size, all started at once
    (each its own group and store; ``jobs`` a list or ``jobs(size)``); a size
    of 0 is one process without a group.  ``meanwhile()``, if given, runs in
    this process while they run."""
    started = {n: start_world(max(n, 1), tmp_path_factory.mktemp(f"world{n}"),
                              jobs(n) if callable(jobs) else jobs, group=n > 0)
               for n in sizes}
    if meanwhile is not None:
        meanwhile()
    return {n: join_world(h, timeout) for n, h in started.items()}


def start_world(world: int, tmp_path, jobs, group: bool = True):
    """Start the ranks of a world (of one process without a group when not
    ``group``); :func:`join_world` waits for them."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    store = "file://" + os.path.join(tmp, "store")
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in paths if p)
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_entry, args=(r, world, store if group else None, tmp,
                                                       jobs), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved
    return world, tmp, procs, time.monotonic()


def join_world(handle, timeout: float = JOIN_TIMEOUT):
    world, tmp, procs, started = handle
    deadline = started + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errors = []
    for r in range(world):
        for what in ("err", "stack"):
            path = os.path.join(tmp, f"rank{r}.{what}")
            if os.path.exists(path) and os.path.getsize(path):
                with open(path) as f:
                    errors.append(f"rank {r} ({what}):\n{f.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"world of {world}: ranks {hung} hung after {timeout} s; exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def digest(tensors: dict) -> str:
    """A hash of a dict of tensors, bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().contiguous().cpu().reshape(-1)
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def slim(rank: int, result: dict) -> dict:
    """A step's result as a rank returns it: rank 0 all of it, the others
    their metrics; each with digests of its state and gradients (their
    bit-equality to rank 0's is what the tests hold of them)."""
    out = {"digests": {k: digest(result[k]) for k in ("state", "grads")},
           "metrics": result["metrics"]}
    return {**result, **out} if rank == 0 else out


def _rank_entry(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    import faulthandler

    # a rank still running near the world's time limit writes where it is
    hang = open(os.path.join(tmp, f"rank{rank}.stack"), "w")
    faulthandler.dump_traceback_later(JOIN_TIMEOUT - 10, file=hang)
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from vqvae2_tpu_torch import parallel as par

        if store is not None:
            par.init_distributed(store, world, rank, device="cpu")
        try:
            results = [getattr(sys.modules[__name__], name)(rank, world, *args)
                       for name, args in jobs]
        finally:
            if store is not None:
                dist.destroy_process_group()
        torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# What the tests hold: collectives, the sync ABN, the trainers' steps
# ---------------------------------------------------------------------------

def collectives(rank: int, world: int) -> dict:
    """The rank queries and each collective under a group."""
    from vqvae2_tpu_torch import parallel as par

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank + 1)
    par.replicate(module)
    tree = {"a": torch.full((2,), float(rank)), "b": [torch.full((1,), float(rank) + 5)]}
    par.replicate(tree)
    start, stop = par.shard_rows(2 * world + 1)
    rows = torch.arange(start, stop, dtype=torch.float32)[:, None] * torch.ones(1, 2)
    offset, total = par.row_offset(stop - start, "cpu")
    index = torch.tensor([0, int(total) - 1, 1, 2 * world], dtype=torch.int64)
    par.synchronize()
    return {"rank": par.get_rank(), "world": par.get_world_size(),
            "local_rank": par.get_local_rank(), "primary": par.is_primary(),
            "all_reduce": par.all_reduce(x), "x_after": x, "all_gather": par.all_gather(x),
            "pmean": par.pmean(x),
            "reduce_dict": par.reduce_dict({"loss": torch.tensor(1.0 + rank),
                                            "n": torch.tensor([rank, 2.0])}),
            "reduce_dict_sum": par.reduce_dict({"loss": torch.tensor(1.0 + rank)},
                                               average=False),
            "replicated": module.weight.detach().clone(), "tree": tree,
            "gather_rows": par.gather_rows(rows, 2 * world + 1),
            "take_rows": par.take_rows(rows, index, offset), "offset": int(offset),
            "total": int(total), "mesh": par.make_mesh("cpu")}


def sync_abn(rank: int, world: int, x: np.ndarray, dz: np.ndarray, w: np.ndarray,
             b: np.ndarray) -> dict:
    """``InPlaceABNSync`` on this rank's rows of ``x``, backward from its rows
    of ``dz`` (the gradient of a global-batch loss), then the gradient
    all-reduce: what each rank holds."""
    from vqvae2_tpu_torch import parallel as par
    from vqvae2_tpu_torch.models.abn import InPlaceABNSync
    from vqvae2_tpu_torch.ops import inplace_abn as ia

    abn = InPlaceABNSync(x.shape[-1])
    with torch.no_grad():
        abn.weight.copy_(torch.from_numpy(w))
        abn.bias.copy_(torch.from_numpy(b))
    xs = torch.from_numpy(par.shard_batch(x)).requires_grad_(True)
    z = abn(xs)
    z.backward(torch.from_numpy(par.shard_batch(dz)))
    own = {"dweight": abn.weight.grad.clone(), "dbias": abn.bias.grad.clone()}
    par.all_reduce_grads(abn.parameters())
    mean, var = ia.batch_moments(xs.detach())
    return {"z": z.detach(), "dx": xs.grad, "own": own, "dweight": abn.weight.grad,
            "dbias": abn.bias.grad, "running_mean": abn.running_mean,
            "running_var": abn.running_var, "mean": mean, "var": var}


def attention_seed(rank: int, world: int, seed: int) -> int:
    """The seed ``causal_flash_attention`` hands the kernel at dropout 0.1,
    from a generator seeded alike on every rank."""
    from vqvae2_tpu_torch.ops import flash_attention as fa

    seen = []
    saved = fa.causal_flash_attention_lse

    def spy(*args, **kwargs):
        seen.append(kwargs["seed"])
        return saved(*args, **kwargs)

    fa.causal_flash_attention_lse = spy
    try:
        q = torch.zeros((1, 1, 3, 4))
        fa.causal_flash_attention(q, q, q, dropout_rate=0.1,
                                  generator=torch.Generator().manual_seed(seed))
    finally:
        fa.causal_flash_attention_lse = saved
    return seen[0]


def _record_ema(model) -> list:
    """Wrap each quantizer's EMA step to record its inputs: the rows, the
    codebook before it, and the (global) counts and sums."""
    from vqvae2_tpu_torch.models.vqvae import Quantize

    records = []
    for name, q in model.named_modules():
        if isinstance(q, Quantize):
            def wrapped(flat, csum, esum, q=q, name=name, orig=q._ema_update):
                records.append({"name": name, "flat": flat.clone(), "embed": q.embed.clone(),
                                "csum": csum.clone(), "esum": esum.clone()})
                orig(flat, csum, esum)
            q._ema_update = wrapped
    return records


def stage1_step(rank: int, world: int, state_dict, cfg: dict, x: np.ndarray, lr: float,
                grad_accum: int = 1) -> dict:
    """One ``train.vqvae`` step on the global batch ``x``."""
    from vqvae2_tpu_torch.models import VQVAE
    from vqvae2_tpu_torch.train import vqvae as tv
    from vqvae2_tpu_torch.utils import schedules

    model = VQVAE(**cfg)
    model.load_state_dict(state_dict)
    tx = schedules.adam(lr)
    state = tv.create_state(model, tx)
    records = _record_ema(model)
    state, metrics = tv.make_train_step(model, tx, grad_accum=grad_accum)(
        state, torch.from_numpy(x))
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "ema": records, "state": model.state_dict(),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def prior_step(rank: int, world: int, hier: str, state_dict, args, code_hw, batch: dict,
               seed: int) -> dict:
    """One ``train.pixelsnail`` step on the global batch."""
    from vqvae2_tpu_torch.train import pixelsnail as tp
    from vqvae2_tpu_torch.train.vqvae import create_state
    from vqvae2_tpu_torch.utils import schedules

    with torch.random.fork_rng(devices=[]):
        model = tp.build_model(hier, args, code_hw=code_hw)
    model.load_state_dict(state_dict)
    tx = schedules.adam(3e-4)
    state = create_state(model, tx)
    state, metrics = tp.make_train_step(model, tx, hier == "bottom", seed=seed)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": model.state_dict(), "metrics": {k: float(v) for k, v in metrics.items()}}


def extract_store(rank: int, world: int, state_dict, cfg: dict, n_images: int, size: int,
                  batch: int, out: str) -> int:
    """``extract_codes.extract`` of ``n_images`` synthetic images into ``out``."""
    from vqvae2_tpu_torch.data.datasets import SyntheticImages
    from vqvae2_tpu_torch.models import VQVAE
    from vqvae2_tpu_torch.train import extract_codes

    model = VQVAE(**cfg)
    model.load_state_dict(state_dict)
    return extract_codes.extract(model, SyntheticImages(n=n_images, size=size), out,
                                 batch_size=batch, size=size, workers=0, device="cpu")


# ---------------------------------------------------------------------------
# The synchronised flax BatchNorm, the differentiable gather, fsdp_shard
# ---------------------------------------------------------------------------

class _CountCollectives:
    """Counts ``all_reduce`` and ``broadcast`` calls of this process."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        import torch.distributed as dist

        self._saved = dist.all_reduce, dist.broadcast
        def counted(fn):
            def wrapper(*a, **k):
                self.n += 1
                return fn(*a, **k)
            return wrapper
        dist.all_reduce, dist.broadcast = counted(self._saved[0]), counted(self._saved[1])
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.broadcast = self._saved


def sync_bn(rank: int, world: int, x: np.ndarray, dy: np.ndarray, scale: np.ndarray,
            bias: np.ndarray) -> dict:
    """The port's ``BatchNorm`` on this rank's rows of ``x``, backward from
    its rows of ``dy``, the gradient all-reduce; then an eval-mode forward,
    counting its collectives."""
    from vqvae2_tpu_torch import parallel as par
    from vqvae2_tpu_torch.models.resnet import BatchNorm

    bn = BatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xs = torch.from_numpy(par.shard_batch(x)).requires_grad_(True)
    with _CountCollectives() as train_calls:
        y = bn(xs)
        y.backward(torch.from_numpy(par.shard_batch(dy)))
    par.all_reduce_grads(bn.parameters())
    with _CountCollectives() as eval_calls, torch.no_grad():
        y_eval = bn.eval()(xs.detach())
    return {"y": y.detach(), "dx": xs.grad, "dscale": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "y_eval": y_eval, "train_collectives": train_calls.n,
            "eval_collectives": eval_calls.n}


def gather_backward(rank: int, world: int, rows: int, groups: int, weights: np.ndarray) -> dict:
    """``gather_batch`` of this rank's ``groups`` blocks of rows, and the
    gradient of ``Σ weights · gathered`` on this rank's own rows."""
    from vqvae2_tpu_torch import parallel as par

    start, stop = par.shard_rows(rows)
    x = torch.cat([torch.arange(start, stop, dtype=torch.float32) + 100 * g
                   for g in range(groups)])[:, None].repeat(1, 2).requires_grad_(True)
    y = par.gather_batch(x, rows, groups)
    (y * torch.from_numpy(weights)).sum().backward()
    return {"gathered": y.detach(), "grad": x.grad,
            "local": par.local_rows(y.detach(), rows, groups)}


def fsdp_steps(rank: int, world: int, state_dict, x: np.ndarray, min_size: int,
               sharded: bool) -> dict:
    """Two Adam steps of a small MLP on the global batch ``x``: its large
    weights sharded by ``fsdp_shard`` or all replicated."""
    from vqvae2_tpu_torch import parallel as par

    model = torch.nn.Sequential(torch.nn.Linear(16, 48), torch.nn.Tanh(), torch.nn.Linear(48, 96),
                                torch.nn.Tanh(), torch.nn.Linear(96, 3))
    model.load_state_dict(state_dict)
    mesh = par.make_mesh("cpu", (par.DATA_AXIS, par.MODEL_AXIS), shape=(world, 1))
    shards = par.fsdp_shard(model, mesh, min_size=min_size) if sharded else None
    params = shards.parameters() if sharded else list(model.parameters())
    opt = torch.optim.Adam(params, lr=1e-2)
    losses = []
    for step in range(2):
        opt.zero_grad(set_to_none=True)
        xs = torch.from_numpy(par.shard_batch(x[step]))
        loss = par.share_mean(torch.square(model(xs)), x.shape[1])
        loss.backward()
        losses.append(float(par.all_reduce(loss.detach())))
        if sharded:
            shards.step(opt)
        else:
            par.all_reduce_grads(model.parameters())
            opt.step()
    held = {name: (tuple(shards.shard_of(p).shape) if sharded else tuple(p.shape),
                   tuple(opt.state[shards.shard_of(p) if sharded else p]["exp_avg"].shape))
            for name, p in model.named_parameters()}
    return {"state": {k: v.clone() for k, v in model.state_dict().items()}, "losses": losses,
            "held": held, "mesh": mesh.shape}


# ---------------------------------------------------------------------------
# The ReID trainer
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _dropout(on: bool):
    """The parsing head's dropout as it is, or the identity within."""
    from vqvae2_tpu_torch.part import part_model

    saved = part_model.dropout
    if not on:
        part_model.dropout = lambda x, *a, **k: x
    try:
        yield
    finally:
        part_model.dropout = saved


def reid_step(rank: int, world: int, state_dict, cfg: dict, batches, grad_accum: int,
              dropout: bool) -> dict:
    """One ``train.reid`` step on the global batch (a list of ``grad_accum``
    microbatches), the gradients before the SGD update and the state after."""
    from vqvae2_tpu_torch.train import reid as tr

    model = tr.EmbedNet2(class_num=cfg["classes"], arch=cfg["arch"])
    model.load_state_dict(state_dict)
    tx = tr.make_optimizer(cfg["lr"], 10)
    state = tr.create_state(model, tx)
    grads = {}
    saved = state.optimizer.step

    def spy(*a, **k):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return saved(*a, **k)

    state.optimizer.step = spy
    step = tr.make_train_step(model, tx, cfg["K"], cfg["P"], cfg["hw"], grad_accum=grad_accum,
                              seed=cfg["seed"])
    with _dropout(dropout):
        state, metrics = step(state, batches[0] if grad_accum == 1 else batches)
    return slim(rank, {"grads": grads,
                       "state": {k: v.clone() for k, v in model.state_dict().items()},
                       "metrics": {k: float(v) for k, v in metrics.items()}})


def lovasz_world(rank: int, world: int, probas: np.ndarray, labels: np.ndarray,
                 groups: int) -> dict:
    """``lovasz_softmax`` on this rank's rows (``groups`` blocks of them) of
    the global batch: its share, the summed value and its gradient."""
    from vqvae2_tpu_torch import parallel as par
    from vqvae2_tpu_torch.part.lovasz import lovasz_softmax

    rows = probas.shape[0] // groups
    start, stop = par.shard_rows(rows)
    take = lambda a: np.concatenate([a[g * rows + start:g * rows + stop]   # noqa: E731
                                     for g in range(groups)])
    p = torch.from_numpy(take(probas)).requires_grad_(True)
    share = lovasz_softmax(p, torch.from_numpy(take(labels)), groups=groups)
    share.backward()
    return {"share": float(share.detach()), "total": float(par.all_reduce(share.detach())),
            "grad": p.grad}


# ---------------------------------------------------------------------------
# The detection trainers
# ---------------------------------------------------------------------------

def _grads_before_step(model, optimizer) -> dict:
    """Record every parameter's gradient as ``optimizer.step`` sees it."""
    grads = {}
    saved = optimizer.step

    def spy(*a, **k):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return saved(*a, **k)

    optimizer.step = spy
    return grads


def ssd_step(rank: int, world: int, state_dict, classes: int, lr: float, total: int,
             batch) -> dict:
    """One ``train.detection`` step of SSD300 on the global batch."""
    from vqvae2_tpu_torch.detection import boxes as B
    from vqvae2_tpu_torch.detection.ssd import SSD300
    from vqvae2_tpu_torch.train import detection as td

    model = SSD300(num_classes=classes)
    model.load_state_dict(state_dict)
    tx = td.make_optimizer(lr, total)
    state = td.create_state(model, tx)
    grads = _grads_before_step(model, state.optimizer)
    state, loss = td.make_train_step(model, tx, B.default_boxes_ssd300())(state, *batch)
    return slim(rank, {"grads": grads,
                       "state": {k: v.clone() for k, v in model.state_dict().items()},
                       "metrics": {"loss": float(loss)}})


def maskrcnn_step(rank: int, world: int, state_dict, cfg: dict, anchors: np.ndarray,
                  batch) -> dict:
    """One ``train.maskrcnn`` step on the global batch."""
    from vqvae2_tpu_torch.detection import mask_rcnn as M
    from vqvae2_tpu_torch.train import maskrcnn as tm
    from vqvae2_tpu_torch.utils import schedules

    model = M.MaskRCNN(**cfg)
    model.load_state_dict(state_dict)
    tx = schedules.adam(1e-4)
    state = tm.create_state(model, tx)
    grads = _grads_before_step(model, state.optimizer)
    state, metrics = tm.make_train_step(model, tx, anchors)(state, *batch)
    return slim(rank, {"grads": grads,
                       "state": {k: v.clone() for k, v in model.state_dict().items()},
                       "metrics": {k: float(v) for k, v in metrics.items()}})


# ---------------------------------------------------------------------------
# The adaptation and StarGAN trainers
# ---------------------------------------------------------------------------

class NarrowSize(int):
    """An ``img_size`` whose StarGAN hourglass starts ``width`` channels wide
    (``2 ** 14 // img_size``)."""

    width = 16

    def __rfloordiv__(self, other):
        return self.width


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def _pinned_gray(w: np.ndarray):
    """The deep trainer's gray mix from fixed weights of the global batch's
    rows (this rank's rows of them)."""
    from vqvae2_tpu_torch.models.pixelsnail import draw_rows

    def mix(generator, img):
        rows, start = draw_rows(img.shape[0])
        assert rows == len(w)
        wl = torch.from_numpy(w[start:start + img.shape[0]])
        return torch.einsum("bhwc,bc->bhw", img, wl)[..., None].repeat(1, 1, 1, 3)

    return mix


def _metrics_only(out):
    """``(state, metrics)`` of a step that also returns images."""
    return out[0], out[1][0]


def _build_adaptation(kind: str, cfg: dict):
    """The port's model, state and step function of one trainer at toy
    widths: ``(model, state, step(state, batch))``."""
    import functools as ft

    from vqvae2_tpu_torch.models import adaptive as ta
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import gray2color as tg2c
    from vqvae2_tpu_torch.train import stargan_bi as tsb
    from vqvae2_tpu_torch.train import vqvae_deep as ttd
    from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
    from vqvae2_tpu_torch.train import vqvae_deep_ir as tir
    from vqvae2_tpu_torch.models.stargan import ModelStarGAN
    from vqvae2_tpu_torch.train.vqvae import TrainState
    from vqvae2_tpu_torch.utils import schedules

    c, k, lr = cfg["classes"], cfg["K"], cfg["lr"]
    adam = schedules.adam
    if kind == "adaptive":
        model = ta.ModelAdaptive(class_num=c)
        tx = (adam(lr), adam(lr))
        state = tad.create_state(model, *tx)
        fn = tad.make_train_step(model, *tx, k)
        return model, state, lambda s, b: _metrics_only(fn(s, b))
    if kind == "gray2color":
        model = ta.ModelAdaptive(class_num=c, ir_head=False)
        tx = adam(lr)
        state = TrainState(step=0, model=model.train(), optimizer=tx.build(model.parameters()))
        fn = tg2c.make_train_step(model, tx)
        return model, state, lambda s, b: _metrics_only(
            fn(s, {"rgb": b["rgb"], "ir": b["ir"]}, torch.from_numpy(b["ids"])))
    if kind in ("vqvae_deep", "vqvae_deep_ir"):
        model = ta.ModelAdaptive_Deep(class_num=c, style_dim=16)
        tx = (adam(lr), adam(lr))
        state = tad.create_state(model, *tx)
        fn = (ttd.make_train_step(model, *tx, k) if kind == "vqvae_deep"
              else tir.make_full_step(model, *tx, k))
        return model, state, fn
    if kind == "vqvae_deep_bi":
        model = ta.ModelAdaptiveBi_Deep(class_num=c)
        tx_reid = schedules.SGDSchedule(tbi.reid_lr_schedule(cfg["lr_f"], 1), weight_decay=5e-4)
        state = tbi.create_state(model, tx_reid, adam(lr))
        return model, state, tbi.make_train_step(model, tx_reid, adam(lr), k)
    if kind == "stargan_bi":
        model = ModelStarGAN(class_num=c, img_size=NarrowSize(cfg["hw"][0]))
        tx = (schedules.SGDSchedule(cfg["lr_f"]), adam(lr), adam(lr))
        state = tsb.create_state(model, *tx)
        fn = tsb.make_train_step(model, *tx, k)
        return model, state, lambda s, b: fn(s, b, {"r1_weight": 1.0, "adv_weight": 0.5,
                                                    "d_mask": 1.0})
    raise ValueError(kind)


def adaptation_step(rank: int, world: int, kind: str, state_dict, cfg: dict, batch) -> dict:
    """One step of an adaptation or StarGAN trainer on the global batch: its
    metrics, every optimizer's gradients as its step saw them, the state
    after."""
    import functools as ft

    from vqvae2_tpu_torch.models import adaptive as ta
    from vqvae2_tpu_torch.train import vqvae_deep as ttd

    with _patched(ta, "VQVAE_Deep", ft.partial(ta.VQVAE_Deep, **cfg["narrow"])), \
            _patched(ttd, "random_gray", _pinned_gray(cfg["gray_w"])):
        model, state, step = _build_adaptation(kind, cfg)
        model.load_state_dict(state_dict)
        grads = {}
        opts = [getattr(state, a) for a in ("opt_reid", "opt_gen", "opt_disc", "optimizer")
                if hasattr(state, a)]
        names = {id(p): n for n, p in model.named_parameters()}
        for opt in opts:
            saved = opt.step

            def spy(*a, opt=opt, saved=saved, **kw):
                grads.update({names[id(p)]: p.grad.clone() for g in opt.param_groups
                              for p in g["params"] if p.grad is not None})
                return saved(*a, **kw)

            opt.step = spy
        state, metrics = step(state, batch)
    return slim(rank, {"grads": grads,
                       "state": {k: v.clone() for k, v in model.state_dict().items()},
                       "metrics": {k: float(v) for k, v in metrics.items()}})


def adaptation_main(rank: int, world: int, kind: str, argv, narrow: dict) -> dict:
    """A deep trainer's ``main`` at world size N (``--device cpu``), its
    ``VQVAE_Deep`` narrowed and ``style_dim`` 16: the metrics it returns."""
    import functools as ft
    import importlib

    from vqvae2_tpu_torch.models import adaptive as ta

    mod = importlib.import_module(f"vqvae2_tpu_torch.train.{kind}")
    with _patched(ta, "VQVAE_Deep", ft.partial(ta.VQVAE_Deep, **narrow)), \
            _patched(mod, "ModelAdaptive_Deep", ft.partial(ta.ModelAdaptive_Deep, style_dim=16)):
        m = mod.main(list(argv))
    return {"metrics": dict(m)}
