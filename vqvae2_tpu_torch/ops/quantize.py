"""Nearest-codebook search for vector quantization (port of
``vqvae2_tpu/ops/quantize.py``).

For rows ``flat (N, D)`` and a codebook ``embed (K, D)``::

    score = (2 * flat @ embed.T - |flat|^2) - |embed|^2        # true fp32
    idx   = argmax(score, 1)                                    # first max wins
    q     = embed[idx]                                          # in flat's dtype

Layout: rows by channels, ``(N, D)`` contiguous — what a ``(B, H, W, D)``
feature map gives with ``reshape(-1, D)`` and no copy; the codebook is
``(K, D)`` as in the JAX package.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/quantize.cu`` (built at first use) or raise; nothing gives way to the
plain version.  On a CPU tensor — and only because the tensor lies on the
CPU — they use the plain PyTorch version below, which is also what the kernels
are compared with on the card.

The search splits its walk over the codebook into ranges of whole 128-code
chunks where the rows alone cannot fill the card (:func:`search_split`); a
merge keeps each row's first maximum, so every split gives the same ids.

Three kernels are ported here:

* ``nearest_code_ids``                 — indices only
* ``nearest_code(with_stats=False)``   — indices and the looked-up rows
* ``nearest_code(with_stats=True)``    — indices, rows and the EMA statistics:
  per-code counts ``csum (K,)`` and sums ``esum (K, D)`` in fp32.  The
  kernel's sums are taken in an order fixed by the ids alone, so ``esum`` is
  the same bit for bit from run to run; it differs from the plain version's
  ``index_add_`` by the rounding of another order.

None is differentiable (the JAX package gives them a zero vjp): the wrappers
run under ``torch.no_grad()`` and callers write the straight-through estimator
themselves.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import Dict, List, Optional, Tuple

import torch

from vqvae2_tpu_torch.ops import _build

# Launches of each CUDA kernel, and uses of the plain version by a wrapper.
# A wrapper adds one where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {
    "nearest_code_ids": 0, "nearest_code_lookup": 0, "nearest_code_stats": 0}
plain_counts: Dict[str, int] = {
    "nearest_code_ids": 0, "nearest_code_lookup": 0, "nearest_code_stats": 0}


def reset_counts() -> None:
    for counts in (launch_counts, plain_counts):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------

def nearest_code_scores(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` scores, term for term as the JAX package computes them."""
    flat32 = flat.to(torch.float32)
    embed32 = embed.to(torch.float32)
    return (
        2.0 * torch.matmul(flat32, embed32.t())
        - torch.sum(flat32 * flat32, dim=1)[:, None]
        - torch.sum(embed32 * embed32, dim=1)[None, :]
    )


def nearest_code_ids_reference(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Plain version of the indices-only kernel: ``idx (N,) int32``."""
    return torch.argmax(nearest_code_scores(flat, embed), dim=1).to(torch.int32)


def nearest_code_lookup_reference(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the lookup kernel: ``(idx (N,) int32, q (N, D))``."""
    idx = torch.argmax(nearest_code_scores(flat, embed), dim=1)
    q = embed.to(torch.float32).index_select(0, idx).to(flat.dtype)
    return idx.to(torch.int32), q


def nearest_code_reference(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain nearest-code search with the EMA statistics.

    Returns ``(indices (N,) int32, quantized (N, D), cluster_sum (K,),
    embed_sum (K, D))``: the same four quantities as the JAX package's
    ``nearest_code_reference``."""
    idx, q = nearest_code_lookup_reference(flat, embed)
    k, d = embed.shape
    long_idx = idx.to(torch.int64)
    cluster_sum = torch.bincount(long_idx, minlength=k).to(torch.float32)
    embed_sum = torch.zeros((k, d), dtype=torch.float32, device=flat.device)
    embed_sum.index_add_(0, long_idx, flat.to(torch.float32))
    return idx, q, cluster_sum, embed_sum


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/quantize.cu)
# ---------------------------------------------------------------------------

# The split of the search (csrc/quantize.cu).  A block of the search kernel
# owns TILE_ROWS rows and walks one range of whole CHUNK-code chunks of the
# codebook; with more than one range a merge kernel takes each row's first
# maximum over the ranges.  Every split gives the same ids (the kernel's
# note), so it is chosen for speed alone.
TILE_ROWS = 128
CHUNK = 128
MAX_RANGES = 16
# A block's start-up (its rows staged, their norms, the ring's first pieces)
# in units of the walk over one chunk: a tenth, as measured at D = 256.
START_UP = 0.1


def code_ranges(k: int, ranges: int) -> List[Tuple[int, int]]:
    """``[first, end)`` codes of each range of a split, as the kernel cuts
    them: range r takes chunks ``[r*C // S, (r+1)*C // S)`` of the ``C``."""
    chunks = -(-k // CHUNK)
    return [(r * chunks // ranges * CHUNK, min(k, (r + 1) * chunks // ranges * CHUNK))
            for r in range(ranges)]


@functools.lru_cache(maxsize=None)
def search_split(n: int, k: int, sms: int) -> int:
    """The number of ranges the search over ``n`` rows and ``k`` codes is
    split into on a card of ``sms`` SMs.

    Where the row tiles alone make four waves or more (the stage-1 shapes:
    thousands of tiles), the whole walk is kept.  Else each count of ranges
    up to MAX_RANGES is timed by a model of the block scheduler: the blocks,
    range after range as they launch, each go to the SM that frees first and
    hold it for START_UP plus their chunks; the fastest wins, fewer ranges
    among equals, but only where it beats the whole walk by more than an
    eighth (a split also pays a merge kernel)."""
    tiles = -(-n // TILE_ROWS)
    if tiles >= 4 * sms:
        return 1

    def makespan(ranges: int) -> float:
        free = [0.0] * sms
        for a, b in code_ranges(k, ranges):
            for _ in range(tiles):
                heapq.heapreplace(free, free[0] + START_UP + -(-(b - a) // CHUNK))
        return max(free)

    times = {s: makespan(s) for s in range(1, min(-(-k // CHUNK), MAX_RANGES) + 1)}
    best = min(times, key=lambda s: (times[s], s))
    return best if 8 * times[best] < 7 * times[1] else 1


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ranges_for(flat: torch.Tensor, embed: torch.Tensor, ranges: Optional[int]) -> int:
    if ranges is not None:
        return ranges
    return search_split(flat.shape[0], embed.shape[0], _sm_count(flat.device.index))


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("quantize")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.vq_search_scratch_bytes.restype = i64
        lib.vq_search_scratch_bytes.argtypes = [i64, i32, i32, i32]
        lib.vq_nearest_ids.restype = i32
        lib.vq_nearest_ids.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, i32, ptr]
        lib.vq_nearest_lookup.restype = i32
        lib.vq_nearest_lookup.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, i32,
                                          ptr]
        lib.vq_stats_scratch_bytes.restype = i64
        lib.vq_stats_scratch_bytes.argtypes = [i64, i32, i32, i32]
        lib.vq_nearest_stats.restype = i32
        lib.vq_nearest_stats.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                         i32, i32, ptr]
        lib.vq_error_string.restype = ctypes.c_char_p
        lib.vq_error_string.argtypes = [i32]
        _lib = lib
    return _lib


def _check_shapes(flat: torch.Tensor, embed: torch.Tensor) -> None:
    if flat.ndim != 2 or embed.ndim != 2 or flat.shape[1] != embed.shape[1]:
        raise ValueError(f"bad shapes {tuple(flat.shape)} vs {tuple(embed.shape)}")
    if flat.device != embed.device:
        raise ValueError(f"flat on {flat.device} but embed on {embed.device}")


def _check_cuda_inputs(flat: torch.Tensor, embed: torch.Tensor) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if not (flat.is_cuda and embed.is_cuda):
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {flat.device} and {embed.device}")
    if flat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flat must be float32 or bfloat16, got {flat.dtype}")
    if embed.dtype != torch.float32:
        raise TypeError(f"embed must be float32, got {embed.dtype}")
    n, d = flat.shape
    if n < 1 or embed.shape[0] < 1 or d < 1:
        raise ValueError(f"need N >= 1, K >= 1 and D >= 1, got N={n}, K={embed.shape[0]}, D={d}")


def _launch(device: torch.device, call):
    """``call(stream)`` on ``device``'s current stream, with ``device`` the
    current one while it launches (switched only where it is not)."""
    if device.index == torch.cuda.current_device():
        return call(torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return call(torch.cuda.current_stream(device).cuda_stream)


def _raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        message = lib.vq_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({message})")


def _nearest_code_ids_cuda(flat: torch.Tensor, embed: torch.Tensor,
                           ranges: Optional[int] = None) -> torch.Tensor:
    _check_cuda_inputs(flat, embed)
    flat, embed = _build.kernel_operands(flat, embed)
    lib = _library()
    n, d = flat.shape
    k = embed.shape[0]
    ranges = _ranges_for(flat, embed, ranges)
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    nbytes = lib.vq_search_scratch_bytes(n, d, k, ranges)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=flat.device)
    code = _launch(flat.device, lambda stream: lib.vq_nearest_ids(
        flat.data_ptr(), embed.data_ptr(), idx.data_ptr(), scratch.data_ptr(), nbytes, n, d, k,
        int(flat.dtype == torch.bfloat16), ranges, stream))
    _raise_on_error(lib, code, "vq_nearest_ids")
    launch_counts["nearest_code_ids"] += 1
    return idx


def _nearest_code_lookup_cuda(
    flat: torch.Tensor, embed: torch.Tensor, ranges: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(flat, embed)
    d_in = flat.shape[1]
    flat, embed = _build.kernel_operands(flat, embed)
    lib = _library()
    n, d = flat.shape
    k = embed.shape[0]
    ranges = _ranges_for(flat, embed, ranges)
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    q = torch.empty((n, d), dtype=flat.dtype, device=flat.device)
    nbytes = lib.vq_search_scratch_bytes(n, d, k, ranges)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=flat.device)
    code = _launch(flat.device, lambda stream: lib.vq_nearest_lookup(
        flat.data_ptr(), embed.data_ptr(), idx.data_ptr(), q.data_ptr(), scratch.data_ptr(),
        nbytes, n, d, k, int(flat.dtype == torch.bfloat16), ranges, stream))
    _raise_on_error(lib, code, "vq_nearest_lookup")
    launch_counts["nearest_code_lookup"] += 1
    return idx, _build.unpad(q, d_in)


# The statistics kernels keep a K-int histogram row in shared memory.
MAX_K_STATS = 12288


def _nearest_code_stats_cuda(
    flat: torch.Tensor, embed: torch.Tensor, ranges: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(flat, embed)
    d_in = flat.shape[1]
    flat, embed = _build.kernel_operands(flat, embed)
    n, d = flat.shape
    k = embed.shape[0]
    if k > MAX_K_STATS or n >= 2 ** 31:
        raise ValueError(
            f"the statistics kernel takes K <= {MAX_K_STATS} and N < 2^31, got K={k}, N={n}")
    lib = _library()
    ranges = _ranges_for(flat, embed, ranges)
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    q = torch.empty((n, d), dtype=flat.dtype, device=flat.device)
    csum = torch.empty((k,), dtype=torch.float32, device=flat.device)
    esum = torch.empty((k, d), dtype=torch.float32, device=flat.device)
    nbytes = lib.vq_stats_scratch_bytes(n, d, k, ranges)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=flat.device)
    code = _launch(flat.device, lambda stream: lib.vq_nearest_stats(
        flat.data_ptr(), embed.data_ptr(), idx.data_ptr(), q.data_ptr(), csum.data_ptr(),
        esum.data_ptr(), scratch.data_ptr(), nbytes, n, d, k, int(flat.dtype == torch.bfloat16),
        ranges, stream))
    _raise_on_error(lib, code, "vq_nearest_stats")
    launch_counts["nearest_code_stats"] += 1
    return idx, _build.unpad(q, d_in), csum, _build.unpad(esum, d_in)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _unsupported_device(flat: torch.Tensor):
    return ValueError(f"nearest-code search takes CPU or CUDA tensors, got {flat.device}")


def _no_rows(flat: torch.Tensor, embed: torch.Tensor):
    k, d = embed.shape
    return (torch.zeros((0,), dtype=torch.int32, device=flat.device),
            torch.zeros((0, d), dtype=flat.dtype, device=flat.device),
            torch.zeros((k,), dtype=torch.float32, device=flat.device),
            torch.zeros((k, d), dtype=torch.float32, device=flat.device))


@torch.no_grad()
def nearest_code_ids(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Indices-only nearest-code search (same argmax as :func:`nearest_code`;
    no quantized rows, for code extraction)."""
    _check_shapes(flat, embed)
    if flat.shape[0] == 0:
        return _no_rows(flat, embed)[0]
    if flat.device.type == "cuda":
        return _nearest_code_ids_cuda(flat, embed)
    if flat.device.type != "cpu":
        raise _unsupported_device(flat)
    plain_counts["nearest_code_ids"] += 1
    return nearest_code_ids_reference(flat, embed)


@torch.no_grad()
def nearest_code(
    flat: torch.Tensor, embed: torch.Tensor, with_stats: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-code search; same contract as :func:`nearest_code_reference`.

    Not differentiable: callers write the straight-through estimator
    themselves.  ``with_stats=False`` (inference, extraction) returns zeros in
    place of the statistics; ``with_stats=True`` (the EMA update of training)
    returns them.  No rows (a rank's empty share of a short batch) launch
    nothing: empty ids and rows, zero statistics."""
    _check_shapes(flat, embed)
    k, d = embed.shape
    if flat.shape[0] == 0:
        return _no_rows(flat, embed)
    if flat.device.type == "cuda":
        if with_stats:
            return _nearest_code_stats_cuda(flat, embed)
        idx, q = _nearest_code_lookup_cuda(flat, embed)
    elif flat.device.type == "cpu":
        if with_stats:
            plain_counts["nearest_code_stats"] += 1
            return nearest_code_reference(flat, embed)
        plain_counts["nearest_code_lookup"] += 1
        idx, q = nearest_code_lookup_reference(flat, embed)
    else:
        raise _unsupported_device(flat)
    zeros = torch.zeros((k * (d + 1),), dtype=torch.float32, device=flat.device)   # one fill
    return idx, q, zeros[:k], zeros[k:].view(k, d)


def quantize_lookup(indices: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Codebook lookup by integer index, any leading shape."""
    return embed[indices.to(torch.int64)]
