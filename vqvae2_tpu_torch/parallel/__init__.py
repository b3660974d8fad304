"""Data parallelism over ``torch.distributed`` (port of
``vqvae2_tpu/parallel/__init__.py``).

The JAX package runs one program over a device mesh: its data-parallel step
*is* the single-device step on the global batch, and sharding is a layout, not
a change of result.  The port runs one process a rank and keeps that rule:

* every rank holds the same global host batch and takes its own rows
  (:func:`shard_batch`: contiguous rows in rank order, the first
  ``rows % world`` ranks one more, a rank of a short batch possibly none);
* each rank backpropagates its share of the global-batch mean, its local mean
  times ``local_rows / global_rows``, and the gradients are summed over the
  ranks (:func:`all_reduce_grads`) — equal and unequal shards alike, and a
  rank with no rows adds zeros;
* statistics over the batch are summed over the ranks before use, inside the
  modules that take them: the quantizer's counts and sums, the in-place ABN's
  moments and gradient sums;
* parameters and buffers start equal (:func:`replicate`) and stay equal: every
  rank applies the same summed gradients and statistics.

The collectives run whenever a process group is up, a group of one rank
included; without a group each is the identity, so a world-1 group gives the
no-group run bit for bit.  Every collective here is an ``all_reduce`` or a
``broadcast``: ``gloo`` takes CUDA tensors in those two only, and ``nccl``
takes no CPU tensor, so host values travel on the backend's device.  A
gather is an all-reduce into a zeroed buffer of the gathered shape, which is
exact.

Losses that pair rows of the batch (batch-hard triplets, InfoNCE, the
per-identity terms) run on the global rows: :func:`gather_batch` hands every
rank the global batch's rows of a tensor, in the JAX package's row order
(``groups`` puts a rank's ``[rgb_r; ir_r; gray_r]`` where the global batch
has ``[rgb_all; ir_all; gray_all]``), and its backward keeps only this
rank's slice of the incoming gradient: every rank computes the same global
term, so the gradient sum counts it once.  Terms per row are this rank's share
of the global mean (:func:`share_mean`); :func:`global_metrics` sums the
ranks' parts of each metric, so every rank reports the global batch's.

The reference's API (``launch``, ``get_rank``, ``is_primary``,
``get_world_size``, ``all_reduce``, ``all_gather``, ``reduce_dict``,
``data_sampler``, ``make_mesh``, ``fsdp_shard``, ...) keeps its names, so the
trainers read the same.  :func:`fsdp_shard` keeps each rank's shard of the
large parameters and of their optimizer moments (:class:`ShardedParams`); a
``model`` mesh axis is taken at size 1, as every trainer's mesh has it.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# How long a rank waits for the others at a collective before it fails.
TIMEOUT = datetime.timedelta(minutes=30)


# ---------------------------------------------------------------------------
# Rank / size queries (reference distributed/distributed.py:17-61)
# ---------------------------------------------------------------------------

def is_initialized() -> bool:
    """Whether a process group is up (the collectives then run)."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    """The rank's index among the ranks of its host: ``LOCAL_RANK`` as
    ``torchrun`` and :func:`launch` set it, else the rank; 0 without a group."""
    if not is_initialized():
        return 0
    return int(os.environ.get("LOCAL_RANK", get_rank()))


def is_primary() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier (reference ``distributed/distributed.py:39-51``)."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# Collectives (the reference's all_reduce / all_gather / reduce_dict)
# ---------------------------------------------------------------------------

def _backend_device(x: torch.Tensor) -> torch.device:
    """Where a collective's tensor must lie: the rank's card under ``nccl``,
    ``x``'s own device under ``gloo``."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return x.device


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank, as a new tensor on
    ``x``'s device (``x`` is left as it is); ``x`` itself without a group."""
    if not is_initialized():
        return x
    buf = x.to(_backend_device(x), copy=True).contiguous()
    dist.all_reduce(buf)
    return buf.to(x.device)


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``(world, *x.shape)``: every rank's ``x`` (all of one shape), stacked
    in rank order, on every rank."""
    if not is_initialized():
        return x[None]
    buf = torch.zeros((get_world_size(), *x.shape), dtype=x.dtype, device=x.device)
    buf[get_rank()] = x
    return all_reduce(buf)


def pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks."""
    if not is_initialized():
        return x
    return all_reduce(x) / get_world_size()


def reduce_dict(d: Dict[str, Any], average: bool = True) -> Dict[str, float]:
    """Metrics as host floats, the same on every rank (reference
    ``distributed/distributed.py:110-132``): each value's mean (``average``)
    or sum over its elements, then over the ranks the mean or the sum.  Every
    rank must call it."""
    keys = sorted(d)
    local = [torch.as_tensor(d[k]).detach().to("cpu", torch.float64) for k in keys]
    local = torch.stack([v.mean() if average else v.sum() for v in local])
    total = all_reduce(local)
    if average:
        total = total / get_world_size()
    return {k: float(v) for k, v in zip(keys, total)}


def from_primary(value: float, device="cpu") -> float:
    """The primary rank's ``value`` on every rank (what it alone computed,
    such as a validation's mAP); every rank must call it."""
    if not is_initialized():
        return value
    x = torch.tensor([value if is_primary() else 0.0], dtype=torch.float64, device=device)
    return float(all_reduce(x)[0])


def local_mean(t: torch.Tensor) -> torch.Tensor:
    """``torch.mean(t)``, and 0 where ``t`` has no element (a rank's empty
    share of a short batch, which the share rule weighs by 0)."""
    return torch.mean(t) if t.numel() else torch.sum(t)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: each rank's share of the loss
    reaches the sum, so the sum's gradient is the ranks' gradients summed."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce` with a gradient: the backward all-reduces the
    incoming gradient (every rank's loss depends on the sum).  ``x`` itself
    without a group."""
    if not is_initialized():
        return x
    return _AllReduceSum.apply(x)


def share_mean(t: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's share of the global batch's mean of ``t``, whose leading
    dim holds this rank's rows of a global batch of ``rows`` rows (each row
    of as many elements): ``local_mean(t) * local_rows / rows``.  The ranks'
    shares sum to the global mean; without a group it is ``mean(t)``."""
    return local_mean(t) * (t.shape[0] / rows)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: int, groups: int):
        start, stop = shard_rows(rows)
        local = stop - start
        if x.shape[0] != groups * local:
            raise ValueError(f"gather_batch: {x.shape[0]} rows, expected {groups} groups of "
                             f"{local} (this rank's share of {rows})")
        buf = torch.zeros((groups * rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
        for g in range(groups):
            buf[g * rows + start:g * rows + stop] = x[g * local:(g + 1) * local]
        ctx.rows, ctx.groups = rows, groups
        return all_reduce(buf)

    @staticmethod
    def backward(ctx, grad):
        return local_rows(grad, ctx.rows, ctx.groups), None, None


def gather_batch(x: torch.Tensor, rows: int, groups: int = 1) -> torch.Tensor:
    """The global batch's rows of ``x`` on every rank, in the global batch's
    order, with a gradient.

    ``x``'s leading dim holds ``groups`` blocks of this rank's rows
    (:func:`shard_rows` of ``rows``), one after the other: a model that
    concatenates its modalities gives ``[rgb_r; ir_r; gray_r]``.  The result
    is ``[rgb_all; ir_all; gray_all]``, ``groups * rows`` rows, as the one
    process computing the global batch lays them out.  The backward hands
    this rank only its own rows of the incoming gradient, summing nothing:
    every rank computes the same global term, and the gradient sum over the
    ranks then counts it once.  Exact (an all-reduce into zeros).  Without a
    group it is a copy of ``x`` through the same autograd node, so that a
    group of one rank accumulates the gradients in the same order, bit for
    bit.  A rank with no rows joins with none."""
    return _GatherBatch.apply(x, rows, groups)


def local_rows(x: torch.Tensor, rows: int, groups: int = 1) -> torch.Tensor:
    """The inverse of :func:`gather_batch`: this rank's rows of a tensor laid
    out as the global batch (``groups`` blocks of ``rows``), as the blocks of
    its own rows one after the other (all of ``x`` without a group)."""
    start, stop = shard_rows(rows)
    if groups == 1:
        return x[start:stop]
    return torch.cat([x[g * rows + start:g * rows + stop] for g in range(groups)])


def global_metrics(shares: Dict[str, torch.Tensor],
                   replicated: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The global batch's metrics on every rank, in one all-reduce.
    ``shares`` are this rank's shares (their sum over the ranks is the
    metric), ``replicated`` the values every rank computed alike on the
    global rows; a key in both is their sum.  Detached 0-dim tensors."""
    replicated = replicated or {}
    keys = sorted(set(shares) | set(replicated))
    world = get_world_size()
    parts = []
    for k in keys:
        v = torch.zeros(())
        if k in shares:
            v = shares[k].detach().to(torch.float32)
        if k in replicated:
            r = replicated[k].detach().to(torch.float32)
            v = v + r / world
        parts.append(v.reshape(()))
    device = next((p.device for p in parts if p.device.type != "cpu"), parts[0].device)
    total = all_reduce(torch.stack([p.to(device) for p in parts]))
    return {k: total[i] for i, k in enumerate(keys)}


def all_reduce_grads(parameters) -> None:
    """Sum every parameter's gradient over the ranks, in place.  Under the
    share rule the sum is the gradient of the global-batch mean.  Parameters
    without a gradient are left alone: every rank runs the same graph (a rank
    with no rows too), so the set is the same on every rank.  ``parameters``
    may be an optimizer: its groups' parameters."""
    if not is_initialized():
        return
    if isinstance(parameters, torch.optim.Optimizer):
        parameters = [p for group in parameters.param_groups for p in group["params"]]
    grads = [p.grad for p in parameters if p.grad is not None]
    for group in _by_dtype_and_device(grads):
        flat = torch._utils._flatten_dense_tensors(group)
        flat = all_reduce(flat)
        for g, r in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
            g.copy_(r)


def _by_dtype_and_device(tensors):
    groups: Dict[Tuple[torch.dtype, torch.device], list] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


# ---------------------------------------------------------------------------
# Rows of the global batch (replace DistributedSampler, distributed.py:135-143)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Mesh:
    """The port's description of the world: a ``data`` axis over the ranks
    of the process group (and, in a ``(data, model)`` mesh, a ``model`` axis
    of size 1), this rank's place on it, and its device."""

    world_size: int
    rank: int
    device: torch.device
    axis_names: Tuple[str, ...] = (DATA_AXIS,)

    @property
    def shape(self) -> Dict[str, int]:
        return {name: self.world_size if name == DATA_AXIS else 1 for name in self.axis_names}


def make_mesh(device="cuda", axis_names: Sequence[str] = (DATA_AXIS,),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The world as it stands: the process group's ranks (one without a
    group) and this rank's device (``resolve_device``: a bare ``cuda`` is the
    rank's own card).

    ``axis_names`` is ``(data,)`` or ``(data, model)``, and ``shape`` their
    sizes, by default ``(world,)`` or ``(world, 1)`` as in the JAX package.
    The ranks all lie on the data axis: the port splits no layer over ranks,
    so a model axis larger than 1 raises."""
    from vqvae2_tpu_torch import resolve_device

    names = tuple(axis_names)
    if names not in ((DATA_AXIS,), (DATA_AXIS, MODEL_AXIS)):
        raise ValueError(f"mesh axes must be ({DATA_AXIS!r},) or ({DATA_AXIS!r}, "
                         f"{MODEL_AXIS!r}), got {names}")
    world = get_world_size()
    want = (world,) + (1,) * (len(names) - 1)
    if shape is not None and tuple(int(n) for n in shape) != want:
        raise ValueError(f"mesh shape {tuple(shape)} over axes {names}: a world of {world} "
                         f"ranks lies on the {DATA_AXIS!r} axis, the {MODEL_AXIS!r} axis "
                         f"is 1 (expected {want})")
    return Mesh(world, get_rank(), resolve_device(device), names)


def default_mesh() -> Mesh:
    return make_mesh()


def shard_rows(rows: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """``(start, stop)`` of this rank's rows among ``rows``: contiguous, in
    rank order, the first ``rows % world`` ranks one more."""
    world, rank = (mesh.world_size, mesh.rank) if mesh else (get_world_size(), get_rank())
    base, extra = divmod(rows, world)
    start = rank * base + min(rank, extra)
    return start, start + base + (rank < extra)


_INDIVISIBLE_WARNED: set = set()


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Optional[Mesh] = None, strict: bool = False):
    """This rank's rows of a global batch (arrays or tensors, or a dict, list
    or tuple of them): the rows :func:`shard_rows` gives along the leading
    dim; 0-dim leaves pass as they are.

    A leading dim that does not divide over the world warns once per
    ``(rows, world)``, and ``strict=True`` raises, as in the JAX package.  The
    result is still the single-process step's: the shards are unequal and the
    share rule weighs them.  (The JAX package replicates such a batch; here
    that would count every row's statistics ``world`` times.)"""
    world = mesh.world_size if mesh else get_world_size()

    def take(x):
        if np.ndim(x) == 0:
            return x
        rows = x.shape[0]
        if rows % world and world > 1:
            if strict:
                raise ValueError(
                    f"shard_batch: leading dim {rows} not divisible by mesh axis "
                    f"{DATA_AXIS!r}={world}; pad the batch or fix the config")
            if (rows, world) not in _INDIVISIBLE_WARNED:
                _INDIVISIBLE_WARNED.add((rows, world))
                warnings.warn(
                    f"shard_batch: leading dim {rows} not divisible by mesh axis "
                    f"{DATA_AXIS!r}={world}; the ranks take unequal shards",
                    RuntimeWarning, stacklevel=4)
        start, stop = shard_rows(rows, mesh)
        return x[start:stop]

    return _tree_map(take, batch)


def local_batch(batch, device):
    """This rank's rows (:func:`shard_batch`) of a global batch of numpy
    arrays or tensors, as tensors on ``device``; a dict, list or tuple."""
    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device)

    return _tree_map(put, shard_batch(batch))


def shard_microbatches(batch, mesh: Optional[Mesh] = None):
    """This rank's rows of an ``(accum, rows, ...)`` superbatch: dim 1 split
    as :func:`shard_batch` splits dim 0, the accumulation dim whole.  Rows that
    do not divide over the world raise, as in the JAX package."""
    world = mesh.world_size if mesh else get_world_size()

    def take(x):
        if np.ndim(x) < 2:
            return x
        if x.shape[1] % world:
            raise ValueError(
                f"shard_microbatches: microbatch rows {x.shape[1]} not divisible by "
                f"mesh axis {DATA_AXIS!r}={world}")
        start, stop = shard_rows(x.shape[1], mesh)
        return x[:, start:stop]

    return _tree_map(take, batch)


def replicate(tree):
    """Make every rank's parameters and buffers rank 0's: a module's, or the
    tensors of a dict, list or tuple, overwritten in place by a broadcast.
    Returns ``tree``."""
    if not is_initialized():
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = [t.data for t in (*tree.parameters(), *tree.buffers())]
    else:
        tensors = []
        _tree_map(lambda t: tensors.append(t) if isinstance(t, torch.Tensor) else None, tree)
    for group in _by_dtype_and_device(tensors):
        flat = torch._utils._flatten_dense_tensors(group)
        buf = flat.to(_backend_device(flat))
        dist.broadcast(buf, src=0)
        flat = buf.to(flat.device)
        for t, r in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
            t.copy_(r)
    return tree


class ShardedParams:
    """Parameters laid out as :func:`fsdp_shard` lays them: each large leaf
    is owned in shards, one a rank, along one dim; the small ones whole on
    every rank.

    :meth:`parameters` are what an optimizer is built over: this rank's
    shards of the large leaves (new leaf tensors) and the small leaves
    themselves, so Adam's moments of a large leaf are sharded with it.
    :meth:`step` takes a step: the gradients of the module's parameters are
    summed over the ranks (:func:`all_reduce_grads`), each rank moves its
    shards' gradients onto them and frees the whole gradients, the optimizer
    updates what this rank owns, and every large leaf is put together again
    on every rank (an all-reduce into zeros) for the next forward.  The
    update is the replicated step's, element for element.  Without a group
    every leaf is whole and :meth:`step` is ``optimizer.step()``."""

    def __init__(self, params, mesh: Optional[Mesh] = None, min_size: int = 2 ** 16):
        world, rank = (mesh.world_size, mesh.rank) if mesh else (get_world_size(), get_rank())
        self.world, self.rank = world, rank
        self.leaves = list(params)
        self.spans: Dict[int, Tuple[int, int, int]] = {}     # leaf -> (dim, start, stop)
        self._owned = []
        for i, p in enumerate(self.leaves):
            dims = [d for d in range(p.ndim) if p.shape[d] % world == 0]
            if world == 1 or p.numel() < min_size or not dims:
                self._owned.append(p)
                continue
            d = max(dims, key=lambda k: p.shape[k])
            size = p.shape[d] // world
            self.spans[i] = (d, rank * size, (rank + 1) * size)
            shard = p.detach().narrow(d, rank * size, size).clone()
            self._owned.append(shard.requires_grad_(p.requires_grad))

    def parameters(self):
        return list(self._owned)

    def shard_of(self, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``leaf`` (the leaf itself when it is whole)."""
        for i, p in enumerate(self.leaves):
            if p is leaf:
                return self._owned[i]
        raise KeyError("not a leaf of these parameters")

    def step(self, optimizer: torch.optim.Optimizer) -> None:
        all_reduce_grads(self.leaves)
        for i, (d, start, stop) in self.spans.items():
            p, shard = self.leaves[i], self._owned[i]
            shard.grad = None if p.grad is None else p.grad.narrow(d, start, stop - start).clone()
            p.grad = None
        optimizer.step()
        self.gather()

    @torch.no_grad()
    def gather(self) -> None:
        """Put every sharded leaf together on every rank from the ranks'
        shards."""
        for i, (d, start, stop) in self.spans.items():
            p = self.leaves[i]
            buf = torch.zeros_like(p)
            buf.narrow(d, start, stop - start).copy_(self._owned[i])
            p.copy_(all_reduce(buf))


def fsdp_shard(module_or_tree, mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
               min_size: int = 2 ** 16) -> ShardedParams:
    """FSDP-style parameter sharding (``vqvae2_tpu.parallel.fsdp_shard``):
    every leaf of at least ``min_size`` elements is sharded over ``axis``
    along its largest dim that divides evenly; smaller leaves, and leaves with
    no such dim, stay whole on every rank.  Takes a module (its parameters) or
    a tree of tensors and returns the :class:`ShardedParams` that own them:
    build the optimizer over its ``parameters()`` and step it with its
    ``step(optimizer)``.  The step is the replicated step's."""
    if axis != DATA_AXIS:
        raise ValueError(f"the port shards over the {DATA_AXIS!r} axis, got {axis!r}")
    if isinstance(module_or_tree, torch.nn.Module):
        leaves = list(module_or_tree.parameters())
    else:
        leaves = []
        _tree_map(lambda t: leaves.append(t) if isinstance(t, torch.Tensor) else None,
                  module_or_tree)
    return ShardedParams(leaves, mesh, min_size)


def data_sampler(dataset_len: int, shuffle: bool, seed: int = 0) -> np.ndarray:
    """The global index permutation of one epoch, as the JAX package draws it
    (every rank draws the same; the batch is what gets split)."""
    if shuffle:
        rng = np.random.default_rng(seed)
        return rng.permutation(dataset_len)
    return np.arange(dataset_len)


# ---------------------------------------------------------------------------
# Rows picked from the global batch (the dead-code restart's draw)
# ---------------------------------------------------------------------------

def row_offset(rows: int, device) -> Tuple[Any, Any]:
    """``(offset, total)``: where this rank's ``rows`` start among the
    concatenation of every rank's rows in rank order, and how many there are
    in all.  Python ints without a group, int64 tensors on ``device`` under
    one (no wait for the host)."""
    if not is_initialized():
        return 0, rows
    counts = all_gather(torch.tensor(rows, dtype=torch.int64, device=device))
    return torch.sum(counts[:get_rank()]), torch.sum(counts)


def take_rows(x: torch.Tensor, index: torch.Tensor, offset) -> torch.Tensor:
    """Rows ``index`` (int64, numbers among every rank's rows concatenated in
    rank order) of that concatenation, on every rank; ``x`` holds this
    rank's rows, which start at ``offset`` (:func:`row_offset`).  Exact: each
    row comes from the one rank that holds it, plus zeros."""
    if not is_initialized():
        return x[index]
    local = index - offset
    mine = (local >= 0) & (local < x.shape[0])
    out = torch.zeros((index.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    if x.shape[0]:
        picked = x[torch.clamp(local, 0, x.shape[0] - 1)]
        out = torch.where(mine.reshape(-1, *([1] * (x.ndim - 1))), picked, out)
    return all_reduce(out)


def gather_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The global batch's ``rows`` rows of an output that each rank computed
    for its own rows (:func:`shard_batch`), on every rank, in row order."""
    if not is_initialized():
        return x
    start, stop = shard_rows(rows)
    buf = torch.zeros((rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    buf[start:stop] = x
    return all_reduce(buf)


# ---------------------------------------------------------------------------
# World setup (replaces distributed/launch.py's spawn + NCCL init)
# ---------------------------------------------------------------------------

def backend_for(device) -> str:
    """``nccl`` for ranks on cards, ``gloo`` for ranks on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda", backend: Optional[str] = None) -> None:
    """Form the process group: ``coordinator_address`` is ``host:port`` (over
    ``tcp://``) or a full ``tcp://`` / ``file://`` address, with
    ``num_processes`` ranks of which this is ``process_id``.  Nothing happens
    when the address and the count are absent (one process, no group).  The
    backend is ``backend`` or :func:`backend_for` ``device``; a failure raises
    and is not retried on another backend."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, num_processes and "
                         "process_id together")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend or backend_for(device), init_method=url,
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def _set_card(device, local_rank: int) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        from vqvae2_tpu_torch import resolve_device

        resolve_device(dev)
        torch.cuda.set_device(dev.index if dev.index is not None else local_rank)


def _spawned_rank(rank: int, fn, args, kwargs, address: str, world: int, device, backend,
                  result_path: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    _set_card(device, rank)
    init_distributed(address, world, rank, device=device, backend=backend)
    try:
        result = fn(*args, **kwargs)
        if rank == 0:
            torch.save(result, result_path)
    finally:
        dist.destroy_process_group()


def launch(fn, *args, device="cuda", backend: Optional[str] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` on every rank of the world and return its
    result (rank 0's where this process spawned the ranks).

    * Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) it
      forms the group from that environment (``env://``), calls ``fn`` and
      destroys the group.
    * Otherwise, with ``device`` a bare ``cuda`` and more than one card, it
      spawns one rank a card over a ``file://`` store in a temporary
      directory; a rank's failure raises here.
    * Otherwise (one card, a given card, the CPU) it calls ``fn`` with no
      group, as the JAX package runs one controller.

    The backend is ``backend``, else ``nccl`` for ``cuda`` and ``gloo`` for
    ``cpu``.  A rank's device is ``cuda:LOCAL_RANK`` for a bare ``cuda``
    (``resolve_device``), the given card otherwise."""
    backend = backend or backend_for(device)
    if _torchrun_env():
        _set_card(device, int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
        try:
            return fn(*args, **kwargs)
        finally:
            dist.destroy_process_group()
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 0
    if cards <= 1:
        return fn(*args, **kwargs)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.pt")
        mp.start_processes(_spawned_rank, args=(fn, args, kwargs,
                                                "file://" + os.path.join(tmp, "store"),
                                                cards, device, backend, result_path),
                           nprocs=cards, join=True, start_method="spawn")
        return torch.load(result_path, weights_only=False)
