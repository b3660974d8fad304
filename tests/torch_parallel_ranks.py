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
    tmp = str(tmp_path)
    store = "file://" + os.path.join(tmp, "store")
    here = os.path.dirname(os.path.abspath(__file__))
    paths = [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in paths if p)
    try:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_entry, args=(r, world, store, tmp, jobs), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if saved is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"world of {world}: ranks {hung} hung after {timeout} s; exit codes "
                             f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_entry(rank: int, world: int, store: str, tmp: str, jobs) -> None:
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from vqvae2_tpu_torch import parallel as par

        par.init_distributed(store, world, rank, device="cpu")
        try:
            results = [getattr(sys.modules[__name__], name)(rank, world, *args)
                       for name, args in jobs]
        finally:
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
