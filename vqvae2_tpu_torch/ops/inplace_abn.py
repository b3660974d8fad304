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
* ``abn_backward`` — the per-channel sums ``edz``, ``eydz`` (partial sums per
  row block, then summed in a fixed order: bit-repeatable) and the ``dx`` pass
  (K8): two entries of the source, ``abn_backward_sums`` and
  ``abn_backward_dx``, launched by one wrapper, which can reduce the sums
  between them

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

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.ops import _build

ACT_LEAKY_RELU = "leaky_relu"
ACT_ELU = "elu"
ACT_NONE = "none"
_ACT_CODES = {ACT_LEAKY_RELU: 0, ACT_ELU: 1, ACT_NONE: 2}

# The sums' grid has one slab of 32 channels per y index (at most 65,535).
MAX_C = 32 * 65535
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
        lib.abn_backward_scratch_bytes.argtypes = [i64, i32]
        lib.abn_backward_sums.restype = i32
        lib.abn_backward_sums.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                          f32, i32, i32, ptr]
        lib.abn_backward_dx.restype = i32
        lib.abn_backward_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                                        f32, f32, i32, ptr]
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
    lib = _library()
    m, c = z2d.shape
    bf16 = int(z2d.dtype == torch.bfloat16)
    dx = torch.empty_like(z2d)
    edz = torch.empty((c,), dtype=torch.float32, device=z2d.device)
    eydz = torch.empty((c,), dtype=torch.float32, device=z2d.device)
    nbytes = lib.abn_backward_scratch_bytes(m, c) if training else 0
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=z2d.device)
    with torch.cuda.device(z2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.abn_backward_sums(
            z2d.data_ptr(), dz2d.data_ptr(), bias_t.data_ptr(), weight_t.data_ptr(),
            edz.data_ptr(), eydz.data_ptr(), scratch.data_ptr(), nbytes, m, c,
            _ACT_CODES[activation], slope, int(training), bf16, stream)
        _raise_on_error(lib, code, "abn_backward_sums")
        g_edz, g_eydz = reduce_sums(edz, eydz) if reduce_sums is not None else (edz, eydz)
        g_edz, g_eydz = g_edz.contiguous(), g_eydz.contiguous()
        code = lib.abn_backward_dx(
            z2d.data_ptr(), dz2d.data_ptr(), dx.data_ptr(), bias_t.data_ptr(),
            weight_t.data_ptr(), mul.data_ptr(), g_edz.data_ptr(), g_eydz.data_ptr(), m, c,
            _ACT_CODES[activation], slope, inv_count, bf16, stream)
    _raise_on_error(lib, code, "abn_backward_dx")
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
