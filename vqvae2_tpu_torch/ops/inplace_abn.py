"""Fused in-place activated batch norm (port of ``vqvae2_tpu/ops/inplace_abn.py``).

For rows ``x (M, C)`` (any ``(..., C)`` input flattened) and per-channel
moments::

    forward   z  = act((x - mean) * rsqrt(var + eps) * (|w| + eps) + b)
    backward  saves only z; (y, dy) = act^-1(z, dz); yhat = (y - b) / (|w| + eps)
              edz = sum dy,  eydz = sum yhat * dy          (per channel, fp32)
              dx  = (dy - edz / n - yhat * eydz / n) * (|w| + eps) * rsqrt(var + eps)
              dw  = sign(w) * eydz,  db = edz

``act`` is leaky_relu(slope), elu or none; compute is fp32 whatever the storage
type (fp32 or bf16), the output is stored in the input's type.  In eval mode
(``training=False``) the moments are constants: the sums are zero.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/inplace_abn.cu`` (built at first use) or raise; nothing gives way to the
plain version.  On a CPU tensor — and only because the tensor lies on the CPU —
they use the plain PyTorch version below, which is also what the kernels are
compared with on the card.  Two kernels are ported:

* ``abn_forward``  — the fused normalise + activate pass (K7)
* ``abn_backward`` — the per-channel sums ``edz``, ``eydz`` and the ``dx``
  pass (K8): two entries of the source, ``abn_backward_sums`` and
  ``abn_backward_dx``, launched by one wrapper, which can reduce the sums
  between them.  Both walk the row partition of :func:`row_partition` —
  whole tiles of rows dealt to persistent blocks (:func:`block_tiles`) —
  which depends on ``(M, C, dtype)`` alone; the sums are taken in a fixed
  order over it (:func:`summation_lanes` says how a block splits a tile), so
  they repeat bit for bit

:func:`batch_moments` stays torch reductions in fp32 with the JAX formula
``E[x^2] - E[x]^2``, as it lies outside the Pallas kernels in the JAX package
too.  Under a process group (``parallel``) the ABN is synchronised, as the JAX
package's moments and sums are over the global batch under GSPMD and over
``axis_name`` under ``shard_map``: the moments come from ``(Σx, Σx², n)``
summed over the ranks, the backward sums ``edz``, ``eydz`` over the ranks
between the two entries, and ``dx`` takes ``1 / n_global``.  ``dweight`` and
``dbias`` are the rank's own sums: the gradient all-reduce adds them up.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.ops import _build

ACT_LEAKY_RELU = "leaky_relu"
ACT_ELU = "elu"
ACT_NONE = "none"
_ACT_CODES = {ACT_LEAKY_RELU: 0, ACT_ELU: 1, ACT_NONE: 2}

# The generic route's sums grid has one slab of 32 channels per y index (at
# most 65,535).
MAX_C = 32 * 65535
# K8's row partition: a tile holds about TILE_BYTES of z (and as much of dz);
# the tiles are dealt to at most PARTITION_BLOCKS persistent blocks, one on
# each of an H100's 132 SMs.
TILE_BYTES = 16384
PARTITION_BLOCKS = 132
# Consumer threads of a K8 block; threads and channels of a block of the
# generic route.
RING_CONSUMERS = 512
GENERIC_THREADS = 256
GENERIC_SLAB = 32
# The elu inversion clamps z here: storage can round z onto the asymptote -1.
ELU_CLAMP = -1.0 + 1e-6

# Launches of each CUDA kernel, and uses of the plain version by a wrapper.
# A wrapper adds one where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"abn_forward": 0, "abn_backward": 0}
plain_counts: Dict[str, int] = {"abn_forward": 0, "abn_backward": 0}


def reset_counts() -> None:
    for counts in (launch_counts, plain_counts):
        for name in counts:
            counts[name] = 0


def _check_activation(activation: str) -> None:
    if activation not in _ACT_CODES:
        raise ValueError(f"activation must be one of {sorted(_ACT_CODES)}, got {activation!r}")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------

def act_forward(y: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    if activation == ACT_LEAKY_RELU:
        return torch.where(y >= 0, y, slope * y)
    if activation == ACT_ELU:
        return torch.where(y >= 0, y, torch.expm1(y))
    return y


def act_invert(z: torch.Tensor, dz: torch.Tensor, activation: str,
               slope: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, dy)`` from ``(z, dz)``; for elu with ``z`` clamped at
    ``ELU_CLAMP``, where ``log1p`` is finite and the contribution is ~0."""
    if activation == ACT_LEAKY_RELU:
        neg = z < 0
        return torch.where(neg, z / slope, z), torch.where(neg, dz * slope, dz)
    if activation == ACT_ELU:
        neg = z < 0
        z_safe = torch.clamp(z, min=ELU_CLAMP)
        return torch.where(neg, torch.log1p(z_safe), z), torch.where(neg, dz * (z_safe + 1.0), dz)
    return z, dz


def abn_forward_reference(x2d: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                          shift: torch.Tensor, activation: str = ACT_LEAKY_RELU,
                          slope: float = 0.01) -> torch.Tensor:
    """Plain version of the forward kernel: ``z (M, C)`` in ``x2d``'s dtype
    from fp32 ``mean``, ``scale = rstd * (|w| + eps)`` and ``shift = b``."""
    y = (x2d.to(torch.float32) - mean[None, :]) * scale[None, :] + shift[None, :]
    return act_forward(y, activation, slope).to(x2d.dtype)


def _yhat_dy(z2d, dz2d, bias_t, weight_t, activation, slope):
    y, dy = act_invert(z2d.to(torch.float32), dz2d.to(torch.float32), activation, slope)
    return (y - bias_t[None, :]) / weight_t[None, :], dy


def abn_backward_sums_reference(
    z2d: torch.Tensor, dz2d: torch.Tensor, bias_t: torch.Tensor, weight_t: torch.Tensor,
    training: bool = True, activation: str = ACT_LEAKY_RELU, slope: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the sums: ``(edz (C,), eydz (C,))``, zero in eval
    mode; ``bias_t = b``, ``weight_t = |w| + eps``."""
    c = z2d.shape[1]
    if not training:
        return (torch.zeros((c,), dtype=torch.float32, device=z2d.device),
                torch.zeros((c,), dtype=torch.float32, device=z2d.device))
    yhat, dy = _yhat_dy(z2d, dz2d, bias_t, weight_t, activation, slope)
    return torch.sum(dy, dim=0), torch.sum(yhat * dy, dim=0)


def abn_backward_dx_reference(
    z2d: torch.Tensor, dz2d: torch.Tensor, bias_t: torch.Tensor, weight_t: torch.Tensor,
    mul: torch.Tensor, edz: torch.Tensor, eydz: torch.Tensor, inv_count: float,
    activation: str = ACT_LEAKY_RELU, slope: float = 0.01,
) -> torch.Tensor:
    """Plain version of the dx pass: ``dx (M, C)`` in z's dtype from the sums;
    ``mul = weight_t * rstd``; ``inv_count`` is ``1 / count`` in training mode."""
    yhat, dy = _yhat_dy(z2d, dz2d, bias_t, weight_t, activation, slope)
    edzn, eydzn = edz * inv_count, eydz * inv_count
    return ((dy - edzn[None, :] - yhat * eydzn[None, :]) * mul[None, :]).to(z2d.dtype)


def abn_backward_reference(
    z2d: torch.Tensor, dz2d: torch.Tensor, bias_t: torch.Tensor, weight_t: torch.Tensor,
    mul: torch.Tensor, inv_count: float, training: bool = True,
    activation: str = ACT_LEAKY_RELU, slope: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: ``(dx (M, C) in z's dtype,
    edz (C,), eydz (C,))``; ``bias_t = b``, ``weight_t = |w| + eps``,
    ``mul = weight_t * rstd``; ``inv_count`` is ``1 / M`` in training mode."""
    edz, eydz = abn_backward_sums_reference(z2d, dz2d, bias_t, weight_t, training, activation,
                                            slope)
    dx = abn_backward_dx_reference(z2d, dz2d, bias_t, weight_t, mul, edz, eydz, inv_count,
                                   activation, slope)
    return dx, edz, eydz


# ---------------------------------------------------------------------------
# K8's row partition and summation order
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def row_partition(m: int, c: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(tile_rows, blocks)`` of K8 for ``M`` rows of ``C`` channels in
    ``dtype``: tiles of whole rows holding about ``TILE_BYTES`` each (fewer
    rows when M is smaller; for rows the ring route takes, a whole number of
    its lanes' rows), dealt to ``blocks`` persistent blocks, at least one tile
    each (:func:`block_tiles`).  Nothing but the shape and the type decides
    it, so the sums repeat from run to run and from card to card."""
    if m < 1 or c < 1:
        raise ValueError(f"need M >= 1 and C >= 1, got M={m}, C={c}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    tile_rows = max(1, min(m, TILE_BYTES // (c * itemsize)))
    lanes = _ring_lanes(c, itemsize)
    if lanes and lanes < tile_rows < m:
        tile_rows -= tile_rows % lanes
    tiles = -(-m // tile_rows)
    return tile_rows, min(PARTITION_BLOCKS, tiles)


def block_tiles(m: int, tile_rows: int, blocks: int) -> List[range]:
    """The tiles of each block in the order the sums pass takes them (the dx
    pass takes them the other way round): block ``b`` takes tiles ``b,
    b + blocks, b + 2 * blocks, ...``, so the blocks sweep the rows together
    and the last tiles of every block are the last rows; tile ``t`` holds
    rows ``[t * tile_rows, min(M, (t + 1) * tile_rows))``."""
    tiles = -(-m // tile_rows)
    return [range(b, tiles, blocks) for b in range(blocks)]


def _ring_lanes(c: int, itemsize: int) -> int:
    """Lanes of the ring route for rows of ``C`` values of ``itemsize``
    bytes, or 0 where it does not take them: rows that are no whole number of
    16-byte vectors, or more vectors than a consumer thread each (two each in
    fp32, where one lane takes every row)."""
    nvec, rest = divmod(c * itemsize, 16)
    most = RING_CONSUMERS * (2 if itemsize == 4 else 1)
    return max(1, RING_CONSUMERS // nvec) if not rest and nvec <= most else 0


def summation_lanes(c: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """How many lanes ``L`` of a K8 block share a channel: lane ``l`` sums
    positions ``l, l + L, ...`` of the block's rows (its tiles' rows in
    order), and the ``L`` lane sums are added in lane order.  Rows of whole
    16-byte vectors, C up to 4096, with the tensors ``aligned`` on 16 bytes,
    take the ring route: a lane owns a vector of ``16 / itemsize`` channels
    (two in fp32 above 2048 channels, where one lane takes every row).
    Anything else takes the generic route: a lane owns a channel of a slab of
    ``min(C, GENERIC_SLAB)``, and ``GENERIC_THREADS / min(C, GENERIC_SLAB)``
    lanes share it."""
    lanes = _ring_lanes(c, torch.empty((), dtype=dtype).element_size())
    return lanes if aligned and lanes else GENERIC_THREADS // min(c, GENERIC_SLAB)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/inplace_abn.cu)
# ---------------------------------------------------------------------------

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("inplace_abn")
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.abn_forward.restype = i32
        lib.abn_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, f32, i32, ptr]
        lib.abn_backward_scratch_bytes.restype = i64
        lib.abn_backward_scratch_bytes.argtypes = [i32, i32]
        lib.abn_backward_sums.restype = i32
        lib.abn_backward_sums.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                          f32, i32, i32, i32, i32, ptr]
        lib.abn_backward_dx.restype = i32
        lib.abn_backward_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                                        f32, f32, i32, i32, i32, ptr]
        lib.abn_error_string.restype = ctypes.c_char_p
        lib.abn_error_string.argtypes = [i32]
        _lib = lib
    return _lib


def _check_cuda_rows(rows: torch.Tensor, vectors, what: str) -> None:
    """Raise on anything the CUDA kernels do not take."""
    tensors = (rows, *vectors)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {[str(t.device) for t in tensors]}")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} must be float32 or bfloat16, got {rows.dtype}")
    if rows.ndim != 2:
        raise ValueError(f"{what} must be (M, C), got {tuple(rows.shape)}")
    m, c = rows.shape
    if m < 1 or not 1 <= c <= MAX_C:
        raise ValueError(f"need M >= 1 and 1 <= C <= {MAX_C}, got M={m}, C={c}")
    for v in vectors:
        if v.dtype != torch.float32 or v.shape != (c,):
            raise TypeError(f"the channel vectors must be float32 ({c},), got {v.dtype} "
                            f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} and the channel vectors must be contiguous")


def _raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        message = lib.abn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({message})")


def _abn_forward_cuda(x2d: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    _check_activation(activation)
    if x2d.ndim == 2 and x2d.shape[0] == 0:
        return torch.empty_like(x2d)      # a rank's empty share: nothing to launch
    _check_cuda_rows(x2d, (mean, scale, shift), "x")
    lib = _library()
    m, c = x2d.shape
    z2d = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.abn_forward(
            x2d.data_ptr(), z2d.data_ptr(), mean.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            m, c, _ACT_CODES[activation], slope, int(x2d.dtype == torch.bfloat16), stream)
    _raise_on_error(lib, code, "abn_forward")
    launch_counts["abn_forward"] += 1
    return z2d


SumsReducer = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _no_rows_backward(z2d, reduce_sums: Optional[SumsReducer]):
    """A rank's empty share: no launch, zero sums, and the reduction joined."""
    c = z2d.shape[1]
    edz = torch.zeros((c,), dtype=torch.float32, device=z2d.device)
    eydz = torch.zeros((c,), dtype=torch.float32, device=z2d.device)
    if reduce_sums is not None:
        reduce_sums(edz, eydz)
    return torch.empty_like(z2d), edz, eydz


def _backward_sums_cuda(z2d, dz2d, bias_t, weight_t, training: bool, activation: str,
                        slope: float, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's first entry on checked CUDA rows, on ``stream`` of their device
    (which is current): ``(edz, eydz)``, zero in eval mode.  One allocation
    holds both and the blocks' partial rows.  Counts no launch (the backward
    does)."""
    lib = _library()
    m, c = z2d.shape
    tile_rows, blocks = row_partition(m, c, z2d.dtype)
    nbytes = lib.abn_backward_scratch_bytes(c, blocks) if training else 0
    buf = torch.empty((2 * c + nbytes // 4,), dtype=torch.float32, device=z2d.device)
    at = buf.data_ptr()
    code = lib.abn_backward_sums(
        z2d.data_ptr(), dz2d.data_ptr(), bias_t.data_ptr(), weight_t.data_ptr(), at, at + 4 * c,
        at + 8 * c, nbytes, m, c, _ACT_CODES[activation], slope, int(training),
        int(z2d.dtype == torch.bfloat16), tile_rows, blocks, stream)
    _raise_on_error(lib, code, "abn_backward_sums")
    return buf[:c], buf[c:2 * c]


def _backward_dx_cuda(z2d, dz2d, bias_t, weight_t, mul, edz, eydz, inv_count: float,
                      activation: str, slope: float, stream: int) -> torch.Tensor:
    """K8's second entry on checked CUDA rows, on ``stream`` of their device
    (which is current): ``dx`` from the sums (this call's, or summed over the
    ranks).  Counts no launch."""
    lib = _library()
    m, c = z2d.shape
    tile_rows, blocks = row_partition(m, c, z2d.dtype)
    dx = torch.empty_like(z2d)
    code = lib.abn_backward_dx(
        z2d.data_ptr(), dz2d.data_ptr(), dx.data_ptr(), bias_t.data_ptr(), weight_t.data_ptr(),
        mul.data_ptr(), edz.data_ptr(), eydz.data_ptr(), m, c, _ACT_CODES[activation], slope,
        inv_count, int(z2d.dtype == torch.bfloat16), tile_rows, blocks, stream)
    _raise_on_error(lib, code, "abn_backward_dx")
    return dx


def _on_device(t: torch.Tensor):
    """A context that makes ``t``'s device current for the launches (none is
    needed where it already is; a context switch costs microseconds, which
    count at K8's smaller shapes)."""
    index = t.get_device()
    return contextlib.nullcontext() if index == torch.cuda.current_device() else \
        torch.cuda.device(index)


def _abn_backward_cuda(
    z2d: torch.Tensor, dz2d: torch.Tensor, bias_t: torch.Tensor, weight_t: torch.Tensor,
    mul: torch.Tensor, inv_count: float, training: bool, activation: str, slope: float,
    reduce_sums: Optional[SumsReducer] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_activation(activation)
    if z2d.ndim == 2 and z2d.shape[0] == 0:
        return _no_rows_backward(z2d, reduce_sums)
    _check_cuda_rows(z2d, (bias_t, weight_t, mul), "z")
    if dz2d.shape != z2d.shape or dz2d.dtype != z2d.dtype or not dz2d.is_cuda:
        raise ValueError(f"dz must be a CUDA {z2d.dtype} {tuple(z2d.shape)}, got "
                         f"{dz2d.device} {dz2d.dtype} {tuple(dz2d.shape)}")
    if not dz2d.is_contiguous():
        raise ValueError("dz must be contiguous")
    _library()   # built at first use, before the device is touched
    with _on_device(z2d):
        stream = torch._C._cuda_getCurrentRawStream(z2d.get_device())
        edz, eydz = _backward_sums_cuda(z2d, dz2d, bias_t, weight_t, training, activation,
                                        slope, stream)
        g_edz, g_eydz = reduce_sums(edz, eydz) if reduce_sums is not None else (edz, eydz)
        dx = _backward_dx_cuda(z2d, dz2d, bias_t, weight_t, mul, g_edz.contiguous(),
                               g_eydz.contiguous(), inv_count, activation, slope, stream)
    launch_counts["abn_backward"] += 1
    return dx, edz, eydz


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def _unsupported_device(t: torch.Tensor):
    return ValueError(f"in-place ABN takes CPU or CUDA tensors, got {t.device}")


def abn_forward(x2d: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, activation: str = ACT_LEAKY_RELU,
                slope: float = 0.01) -> torch.Tensor:
    """The forward kernel on a CUDA tensor, its plain version on a CPU one;
    no rows launch nothing."""
    if x2d.device.type == "cuda":
        return _abn_forward_cuda(x2d, mean, scale, shift, activation, slope)
    if x2d.device.type != "cpu":
        raise _unsupported_device(x2d)
    _check_activation(activation)
    if x2d.shape[0] == 0:
        return torch.empty_like(x2d)
    plain_counts["abn_forward"] += 1
    return abn_forward_reference(x2d, mean, scale, shift, activation, slope)


def abn_backward(
    z2d: torch.Tensor, dz2d: torch.Tensor, bias_t: torch.Tensor, weight_t: torch.Tensor,
    mul: torch.Tensor, inv_count: float, training: bool = True,
    activation: str = ACT_LEAKY_RELU, slope: float = 0.01,
    reduce_sums: Optional[SumsReducer] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on a CUDA tensor, the plain version on a CPU one:
    ``(dx, edz, eydz)`` as :func:`abn_backward_reference`.  ``reduce_sums``
    (the sync ABN's all-reduce) maps the sums to the ones the dx pass takes;
    the sums returned are this call's own.  No rows launch nothing."""
    if z2d.device.type == "cuda":
        return _abn_backward_cuda(z2d, dz2d, bias_t, weight_t, mul, inv_count, training,
                                  activation, slope, reduce_sums)
    if z2d.device.type != "cpu":
        raise _unsupported_device(z2d)
    _check_activation(activation)
    if z2d.shape[0] == 0:
        return _no_rows_backward(z2d, reduce_sums)
    plain_counts["abn_backward"] += 1
    edz, eydz = abn_backward_sums_reference(z2d, dz2d, bias_t, weight_t, training, activation,
                                            slope)
    g_edz, g_eydz = reduce_sums(edz, eydz) if reduce_sums is not None else (edz, eydz)
    dx = abn_backward_dx_reference(z2d, dz2d, bias_t, weight_t, mul, g_edz, g_eydz, inv_count,
                                   activation, slope)
    return dx, edz, eydz


def _transformed(weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], c: int,
                 eps: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(|w| + eps, b)`` in fp32, ``(1, 0)`` without an affine transform."""
    if weight is None:
        return (torch.ones((c,), dtype=torch.float32, device=device),
                torch.zeros((c,), dtype=torch.float32, device=device))
    return torch.abs(weight).to(torch.float32) + eps, bias.to(torch.float32)


def _sum_over_ranks(edz: torch.Tensor, eydz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    both = par.all_reduce(torch.stack([edz, eydz]))
    return both[0], both[1]


class InPlaceABNFunction(torch.autograd.Function):
    """The forward kernel bound to the backward kernels: ``apply(x, weight,
    bias, mean, var, eps, activation, slope, training, count) -> z``.  Saves
    only ``z`` of the activation's size (and the per-channel vectors), as the
    JAX package's ``custom_vjp`` does.  ``mean`` and ``var`` get no gradient:
    their dependence on ``x`` in training mode is in the ``edz`` / ``eydz``
    terms.  ``count`` is the rows the moments were taken over: under a
    process group the global batch's, and the backward sums are then summed
    over the ranks before the dx pass."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps: float, activation: str, slope: float,
                training: bool, count: int):
        c = x.shape[-1]
        w_t, b_t = _transformed(weight, bias, c, eps, x.device)
        rstd = torch.rsqrt(var.to(torch.float32) + eps)
        x2d = x.reshape(-1, c).contiguous()
        z2d = abn_forward(x2d, mean.to(torch.float32).contiguous(), (rstd * w_t).contiguous(),
                          b_t.contiguous(), activation, slope)
        ctx.save_for_backward(z2d, rstd, weight, w_t, b_t)
        ctx.activation, ctx.slope, ctx.training, ctx.count = activation, slope, training, count
        ctx.has_affine = weight is not None
        return z2d.reshape(x.shape)

    @staticmethod
    def backward(ctx, dz):
        z2d, rstd, weight, w_t, b_t = ctx.saved_tensors
        inv_count = (1.0 / ctx.count) if ctx.training else 0.0
        sync = ctx.training and par.is_initialized()
        dz2d = dz.reshape(z2d.shape).to(z2d.dtype).contiguous()
        dx2d, edz, eydz = abn_backward(z2d, dz2d, b_t, w_t, (w_t * rstd).contiguous(),
                                       inv_count, ctx.training, ctx.activation, ctx.slope,
                                       _sum_over_ranks if sync else None)
        dweight = dbias = None
        if ctx.has_affine:
            # this rank's own sums: the gradient all-reduce adds the ranks' up
            dweight = (torch.sign(weight) * eydz).to(weight.dtype)   # the reference's sign flip
            dbias = edz.to(weight.dtype)
        return dx2d.reshape(dz.shape), dweight, dbias, None, None, None, None, None, None, None


def inplace_abn(x: torch.Tensor, weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
                activation: str = ACT_LEAKY_RELU, slope: float = 0.01,
                training: bool = True, count: Optional[int] = None) -> torch.Tensor:
    """Normalise and activate ``x (..., C)`` with the given per-channel
    moments.  ``weight``/``bias`` may be None (affine off).  The caller
    computes the moments (:func:`batch_statistics`) and owns the running-stat
    update; ``mean``/``var`` are taken as constants.  ``count``: the rows the
    moments are over (the global batch's under a process group), which
    :func:`batch_statistics` returns; left out, it is counted here (eval mode
    takes none)."""
    _check_activation(activation)
    if count is None:
        count = _global_rows(x) if training else x.numel() // x.shape[-1]
    return InPlaceABNFunction.apply(x, weight, bias, mean.detach(), var.detach(), eps,
                                    activation, slope, training, count)


def _global_rows(x: torch.Tensor) -> int:
    """The rows of ``x (..., C)`` over every rank of the process group."""
    rows = x.numel() // x.shape[-1]
    if not par.is_initialized():
        return rows
    return int(par.all_reduce(torch.tensor([rows], dtype=torch.int64, device=x.device))[0])


@torch.no_grad()
def batch_statistics(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel (biased) mean and variance over all non-channel dims, in
    fp32, and the rows they are over: ``E[x]`` and ``E[x^2] - E[x]^2`` from
    ``(Σx, Σx², n)``, which under a process group are summed over the ranks
    (in float64, one all-reduce) first."""
    c = x.shape[-1]
    x2d = x.reshape(-1, c).to(torch.float32)
    s1, s2, n = torch.sum(x2d, dim=0), torch.sum(torch.square(x2d), dim=0), x2d.shape[0]
    if par.is_initialized():
        sums = par.all_reduce(torch.cat([s1.to(torch.float64), s2.to(torch.float64),
                                         torch.tensor([n], dtype=torch.float64, device=x.device)]))
        s1, s2, n = sums[:c].to(torch.float32), sums[c:2 * c].to(torch.float32), int(sums[-1])
    mean = s1 / n
    return mean, s2 / n - torch.square(mean), n


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean, var)`` of :func:`batch_statistics`."""
    return batch_statistics(x)[:2]
