"""Strictly-causal attention for the PixelSNAIL prior (port of
``vqvae2_tpu/ops/flash_attention.py``).

For ``q, k, v (B, H, N, D)``: query ``i`` attends keys ``j < i`` only, the
scores are ``(q·kᵀ)·(1/√D)`` in true fp32, and row 0, which attends nothing,
gives exactly zero.  Dropout, when on, acts on the normalised probabilities:
the softmax normaliser is summed over the undropped ones.

On a CUDA tensor the wrappers launch the hand-written kernel of
``csrc/flash_attention.cu`` (built at first use) or raise; nothing gives way to
the plain version.  On a CPU tensor — and only because the tensor lies on the
CPU — they use the plain full-matrix version below, which is also what the
kernel is compared with on the card.

The kernel draws its dropout mask from Philox-4x32-10 keyed on the absolute
``(seed, bh, i, j)`` element; :func:`dropout_keep_reference` is the same draw
in plain integer tensor arithmetic, and ``dropout_keep_mask`` exports the
kernel's own mask, so the plain version — which takes an explicit ``keep`` —
can be held against the kernel with dropout on.  Under a process group each
rank adds :func:`shard_seed_offset` of its rank to the seed it draws, the JAX
package's rule for a batch shard, so the ranks draw distinct masks and rank 0
draws what one process draws.

The gradient: :class:`CausalFlashAttention` binds the forward kernel (which
saves ``lse``) to the two backward kernels of the same source, one for ``dq``
(which also sums ``dsum = Σ_d do·o``) and one for ``dk, dv``; they recompute
the probabilities from ``lse`` and regenerate the dropout mask from the same
seed, so nothing of size ``N²`` is kept between the passes.  The wrappers take
it for a CUDA input whenever grad is enabled and an input requires it.  On the
CPU the plain version stays ordinary differentiable PyTorch;
:func:`causal_attention_backward_reference` is the kernels' formula written
out, the yardstick of the backward kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.ops import _build

NEG_INF = -1e30          # the fill of masked scores (not -inf: NaN from inf - inf)

# Launches of the CUDA kernel, and uses of the plain version by the wrapper.
# The wrapper adds one where it launches the kernel and nowhere else.
_KERNELS = ("causal_flash_attention", "causal_flash_attention_dq", "causal_flash_attention_dkv")
launch_counts: Dict[str, int] = dict.fromkeys(_KERNELS, 0)
plain_counts: Dict[str, int] = dict.fromkeys(_KERNELS, 0)


def reset_counts() -> None:
    for counts in (launch_counts, plain_counts):
        for name in counts:
            counts[name] = 0


# The JAX package's ``_shard_seed_offset`` multiplier: odd, so the offsets of
# distinct ranks differ modulo 2**32, and modulo 2**64, the port's seed width.
SHARD_SEED_MULTIPLIER = 0x632BE5AB


def shard_seed_offset(rank: int) -> int:
    """What rank ``rank`` adds to its dropout seed (0 for rank 0)."""
    return (rank * SHARD_SEED_MULTIPLIER) % 2 ** 64


def dropout_threshold(rate: float) -> int:
    """An element is kept when its 32 random bits are ``>=`` this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path, and the yardstick of the kernel)
# ---------------------------------------------------------------------------

def causal_attention_reference_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    keep: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-matrix strictly-causal attention on ``(..., N, D)``.

    ``keep`` — ``(..., N, N)`` mask of the probabilities that survive dropout
    (any dtype; non-zero keeps); required when ``dropout_rate > 0``.  Returns
    ``(o (..., N, D) in q's dtype, lse (..., N, 1) fp32)``; ``lse`` is the
    log-sum-exp of each row's visible scores (``-1e30`` for row 0)."""
    n, d = q.shape[-2:]
    q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
    s = torch.matmul(q32, k32.transpose(-1, -2)) / math.sqrt(d)
    qi = torch.arange(n, device=q.device)[:, None]
    kj = torch.arange(n, device=q.device)[None, :]
    s = torch.where(kj < qi, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = p * (qi > 0).to(p.dtype)            # row 0 attends nothing
    if dropout_rate > 0.0:
        if keep is None:
            raise ValueError("dropout_rate > 0 needs an explicit keep mask")
        p = p * (keep != 0).to(p.dtype) / (1.0 - dropout_rate)
    o = torch.matmul(p, v32).to(q.dtype)
    return o, torch.logsumexp(s, dim=-1, keepdim=True)


def causal_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    keep: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Plain version of the kernel's ``o``; see
    :func:`causal_attention_reference_lse`."""
    return causal_attention_reference_lse(q, k, v, keep=keep, dropout_rate=dropout_rate)[0]


def causal_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, keep: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels on ``(..., N, D)``: the gradients
    of :func:`causal_attention_reference` given its ``o``, ``lse`` and the
    upstream ``do``, by the formula the kernels compute — ``p`` recomputed
    from ``lse`` (zero where ``j >= i``), ``dsum = Σ_d do·o``, ``dp = do·vᵀ``
    times ``keep / (1 − rate)``, ``ds = p·(dp − dsum)/√D``; ``dq = ds·k``,
    ``dk = dsᵀ·q``, ``dv = (p·keep/(1 − rate))ᵀ·do``.  ``keep`` as in the
    forward.  Returns ``(dq, dk, dv)`` in the inputs' dtype."""
    n, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, o32, do32 = (t.to(torch.float32) for t in (q, k, v, o, do))
    qi = torch.arange(n, device=q.device)[:, None]
    kj = torch.arange(n, device=q.device)[None, :]
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    p = torch.where(kj < qi, torch.exp(s - lse), torch.zeros_like(s))
    dsum = torch.sum(do32 * o32, dim=-1, keepdim=True)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    p_drop = p
    if dropout_rate > 0.0:
        if keep is None:
            raise ValueError("dropout_rate > 0 needs an explicit keep mask")
        m = (keep != 0).to(torch.float32) / (1.0 - dropout_rate)
        dp = dp * m
        p_drop = p * m
    ds = p * (dp - dsum) * scale
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    dv = torch.matmul(p_drop.transpose(-1, -2), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _philox4x32_10(ctr, key):
    """Philox-4x32-10 on int64 tensors holding 32-bit words."""
    mask = 0xFFFFFFFF
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & mask
        k1 = (k1 + 0xBB67AE85) & mask
    return c0, c1, c2, c3


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``a * b`` for a 32-bit constant ``a`` and
    32-bit words ``b`` held in int64 (whose products would overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi & 0xFFFFFFFF, lo


def dropout_keep_reference(seed: int, bh: int, n: int, dropout_rate: float,
                           device="cpu") -> torch.Tensor:
    """The kernel's keep mask ``(bh, n, n)`` (bool) in plain tensor arithmetic:
    element ``(b, i, j)`` takes word ``j % 4`` of Philox-4x32-10 with counter
    ``(j // 4, i, b, 0)`` and key ``(seed & 0xffffffff, seed >> 32)``, and is
    kept when that word is ``>= dropout_threshold(rate)``.  For small shapes."""
    quads = (n + 3) // 4
    b = torch.arange(bh, dtype=torch.int64, device=device)[:, None, None]
    i = torch.arange(n, dtype=torch.int64, device=device)[None, :, None]
    quad = torch.arange(quads, dtype=torch.int64, device=device)[None, None, :]
    shape = (bh, n, quads)
    ctr = (quad.expand(shape), i.expand(shape), (b & 0xFFFFFFFF).expand(shape),
           (b >> 32).expand(shape))
    key = (torch.full(shape, seed & 0xFFFFFFFF, dtype=torch.int64, device=device),
           torch.full(shape, (seed >> 32) & 0xFFFFFFFF, dtype=torch.int64, device=device))
    words = torch.stack(_philox4x32_10(ctr, key), dim=-1)        # (bh, n, quads, 4)
    return (words >= dropout_threshold(dropout_rate)).reshape(bh, n, quads * 4)[:, :, :n]


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("flash_attention")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        u32, u64, f32 = ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_float
        lib.fa_forward.restype = i32
        lib.fa_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, u32, f32, u64,
                                   ptr]
        for name in ("fa_backward_dq", "fa_backward_dkv"):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = [ptr] * 8 + [i64, i32, i32, i32, i32, i32, i32, u32, f32,
                                                       u64, ptr]
        lib.fa_keep_mask.restype = i32
        lib.fa_keep_mask.argtypes = [ptr, i64, i32, u32, u64, ptr]
        lib.fa_error_string.restype = ctypes.c_char_p
        lib.fa_error_string.argtypes = [i32]
        _lib = lib
    return _lib


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {q.device}, {k.device} and {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, n, d = q.shape
    if bh < 1 or n < 1 or d < 1:
        raise ValueError(f"need BH >= 1, N >= 1 and D >= 1, got BH={bh}, N={n}, D={d}")


def _check_dropout(dropout_rate: float) -> None:
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must lie in [0, 1), got {dropout_rate}")


def _raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        message = lib.fa_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({message})")


def _causal_flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dropout_rate: float, seed: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(q, k, v)
    _check_dropout(dropout_rate)
    lib = _library()
    head_dim = q.shape[2]
    q, k, v = _build.kernel_operands(q, k, v)
    bh, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, d,
            head_dim, int(q.dtype == torch.bfloat16), dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate), seed & 0xFFFFFFFFFFFFFFFF, stream)
    _raise_on_error(lib, code, "fa_forward")
    launch_counts["causal_flash_attention"] += 1
    return _build.unpad(o, head_dim), lse


# The backward kernels' feature tiles: one tile for a head up to 64 features,
# and above that tiles of WIDE_TILE columns, each a column group of the output.
# The forward kernel's entry picks the same tiling from D itself.
NARROW_TILES = (16, 32, 64)
WIDE_TILE = 128


def backward_tiling(d: int) -> Tuple[int, int]:
    """``(tile, groups)`` of the backward kernels for a head of ``d``
    features: the narrowest of 16, 32 and 64 that holds it, in one group;
    above 64, ``WIDE_TILE``-wide tiles, as many groups as cover ``d``.  The
    variant computes the scores and ``dP`` once for all of a group's
    columns."""
    if d < 1:
        raise ValueError(f"need d >= 1, got {d}")
    for tile in NARROW_TILES:
        if d <= tile:
            return tile, 1
    return WIDE_TILE, -(-d // WIDE_TILE)


def _backward_args(q: torch.Tensor, dropout_rate: float, seed: int,
                   head_dim: Optional[int]) -> tuple:
    bh, n, d = q.shape
    return (bh, n, d, head_dim or d, int(q.dtype == torch.bfloat16), *backward_tiling(d),
            dropout_threshold(dropout_rate), 1.0 / (1.0 - dropout_rate),
            seed & 0xFFFFFFFFFFFFFFFF)


def _backward_dq_cuda(q, k, v, o, lse, do, dropout_rate: float, seed: int,
                      head_dim: Optional[int] = None):
    """The dq kernel on operands as the kernels take them (``head_dim``: the
    width before the pad, if any): ``(dq, dsum)``."""
    lib = _library()
    dq = torch.empty_like(q)
    dsum = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.fa_backward_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                                  *_backward_args(q, dropout_rate, seed, head_dim),
                                  torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, code, "fa_backward_dq")
    launch_counts["causal_flash_attention_dq"] += 1
    return dq, dsum


def _backward_dkv_cuda(q, k, v, do, lse, dsum, dropout_rate: float, seed: int,
                       head_dim: Optional[int] = None):
    """The dk/dv kernel, after the dq kernel wrote ``dsum``, on operands as
    the kernels take them: ``(dk, dv)``."""
    lib = _library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = lib.fa_backward_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                   *_backward_args(q, dropout_rate, seed, head_dim),
                                   torch.cuda.current_stream().cuda_stream)
    _raise_on_error(lib, code, "fa_backward_dkv")
    launch_counts["causal_flash_attention_dkv"] += 1
    return dk, dv


def _causal_flash_attention_backward_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, dropout_rate: float, seed: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_cuda_inputs(q, k, v)
    _check_dropout(dropout_rate)
    bh, n, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, n, 1):
        raise ValueError(f"o, do must be {tuple(q.shape)} and lse {(bh, n, 1)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"o and do must be {q.dtype} and lse float32, got "
                        f"{o.dtype}, {do.dtype}, {lse.dtype}")
    lse = lse.contiguous()
    head_dim = d
    q, k, v, o, do = _build.kernel_operands(q, k, v, o, do)
    dq, dsum = _backward_dq_cuda(q, k, v, o, lse, do, dropout_rate, seed, head_dim)
    dk, dv = _backward_dkv_cuda(q, k, v, do, lse, dsum, dropout_rate, seed, head_dim)
    return _build.unpad(dq, head_dim), _build.unpad(dk, head_dim), _build.unpad(dv, head_dim)


def dropout_keep_mask(bh: int, n: int, dropout_rate: float, seed: int,
                      device="cuda") -> torch.Tensor:
    """The keep mask ``(bh, n, n)`` (uint8) that the kernel draws for this
    seed and rate, written by the kernel's own generator on the card.  It is
    of size ``N²``: for comparisons at small N."""
    _check_dropout(dropout_rate)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the kernel's mask is drawn on the card, got device {dev}")
    if bh < 1 or n < 1:
        raise ValueError(f"need BH >= 1 and N >= 1, got BH={bh}, N={n}")
    lib = _library()
    keep = torch.empty((bh, n, n), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fa_keep_mask(keep.data_ptr(), bh, n, dropout_threshold(dropout_rate),
                                seed & 0xFFFFFFFFFFFFFFFF, stream)
    _raise_on_error(lib, code, "fa_keep_mask")
    return keep


# ---------------------------------------------------------------------------
# Forward and backward by device, and the autograd binding
# ---------------------------------------------------------------------------

def _check_cpu_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dropout_rate: float) -> None:
    """Device, shape and rate checks of the plain path."""
    if q.device.type != "cpu":
        raise ValueError(f"causal attention takes CPU or CUDA tensors, got {q.device}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_dropout(dropout_rate)


def _keep_for(seed: int, q: torch.Tensor, dropout_rate: float) -> Optional[torch.Tensor]:
    if dropout_rate == 0.0:
        return None
    return dropout_keep_reference(seed, q.shape[0], q.shape[1], dropout_rate)


def _forward(q, k, v, dropout_rate: float, seed: int):
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if q.device.type == "cuda":
        return _causal_flash_attention_cuda(q, k, v, dropout_rate, seed)
    _check_cpu_inputs(q, k, v, dropout_rate)
    plain_counts["causal_flash_attention"] += 1
    return causal_attention_reference_lse(q, k, v, keep=_keep_for(seed, q, dropout_rate),
                                          dropout_rate=dropout_rate)


def _backward(q, k, v, o, lse, do, dropout_rate: float, seed: int):
    """Kernels for a CUDA tensor, plain version for a CPU tensor."""
    if q.device.type == "cuda":
        return _causal_flash_attention_backward_cuda(q, k, v, o, lse, do, dropout_rate, seed)
    _check_cpu_inputs(q, k, v, dropout_rate)
    plain_counts["causal_flash_attention_dq"] += 1
    plain_counts["causal_flash_attention_dkv"] += 1
    return causal_attention_backward_reference(
        q, k, v, o, lse, do, keep=_keep_for(seed, q, dropout_rate), dropout_rate=dropout_rate)


class CausalFlashAttention(torch.autograd.Function):
    """The forward kernel bound to the two backward kernels: ``apply(q, k, v,
    dropout_rate, seed) -> (o, lse)`` on ``(BH, N, D)``.  Saves ``(q, k, v,
    o, lse)`` and the seed, as the JAX package's ``custom_vjp`` does; ``lse``
    and the seed get no gradient.  On CPU tensors it runs the plain versions
    (forward and the written-out backward), which is how the binding itself is
    tested without a card."""

    @staticmethod
    def forward(ctx, q, k, v, dropout_rate: float, seed: int):
        o, lse = _forward(q, k, v, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.dropout_rate, ctx.seed = dropout_rate, seed
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do.to(o.dtype).contiguous(),
                               ctx.dropout_rate, ctx.seed)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------

def causal_flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (BH, N, D) in q's dtype, lse (BH, N, 1) fp32)`` from contiguous
    ``q, k, v (BH, N, D)``.  ``seed`` keys the dropout draw; the CPU path
    draws the same mask as the kernel (:func:`dropout_keep_reference`).  On
    the card, with grad enabled and an input that requires it, the result is
    differentiable through the backward kernels."""
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return CausalFlashAttention.apply(q, k, v, dropout_rate, seed)
    return _forward(q, k, v, dropout_rate, seed)


def causal_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Strictly-causal multi-head attention without the ``(N, N)`` matrix in
    device memory.

    ``q, k, v`` — ``(B, H, N, D)``, fp32 or bf16, any ``N >= 1`` and
    ``D >= 1``.  ``dropout_rate > 0`` needs a ``generator``, from
    which the seed of the kernel's counter-based draw is taken, plus the
    rank's :func:`shard_seed_offset` under a process group.  Returns
    ``(B, H, N, D)`` in ``q``'s dtype."""
    if q.ndim != 4:
        raise ValueError(f"q, k, v must be (B, H, N, D), got {tuple(q.shape)}")
    b, h, n, d = q.shape
    seed = 0
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 requires a generator")
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
        seed = (seed + shard_seed_offset(par.get_rank())) % 2 ** 64
    flat = [t.reshape(b * h, n, d).contiguous() for t in (q, k, v)]
    o, _ = causal_flash_attention_lse(*flat, dropout_rate=dropout_rate, seed=seed)
    return o.reshape(b, h, n, d)
