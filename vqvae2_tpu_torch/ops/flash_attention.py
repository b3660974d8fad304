"""Strictly-causal attention for the PixelSNAIL prior (port of
``vqvae2_tpu/ops/flash_attention.py``, forward only so far).

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
can be held against the kernel with dropout on.

No gradient yet: the backward kernels come with the stage-2 training slice of
the port, and a CUDA input that requires grad raises ``NotImplementedError``.
The plain version on the CPU is ordinary differentiable PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from vqvae2_tpu_torch.ops import _build

NEG_INF = -1e30          # the fill of masked scores (not -inf: NaN from inf - inf)
MAX_HEAD_DIM = 64

# Launches of the CUDA kernel, and uses of the plain version by the wrapper.
# The wrapper adds one where it launches the kernel and nowhere else.
launch_counts: Dict[str, int] = {"causal_flash_attention": 0}
plain_counts: Dict[str, int] = {"causal_flash_attention": 0}


def reset_counts() -> None:
    for counts in (launch_counts, plain_counts):
        for name in counts:
            counts[name] = 0


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
        lib.fa_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, u32, f32, u64, ptr]
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
    if bh < 1 or n < 1:
        raise ValueError(f"need BH >= 1 and N >= 1, got BH={bh}, N={n}")
    if d % 4 != 0 or not 4 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"D must be a multiple of 4 (16-byte loads) up to {MAX_HEAD_DIM}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary")


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "causal_flash_attention has no backward kernel yet: the gradient comes with "
            "the stage-2 training slice of the port (run under torch.no_grad())")
    lib = _library()
    bh, n, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, d,
            int(q.dtype == torch.bfloat16), dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate), seed & 0xFFFFFFFFFFFFFFFF, stream)
    _raise_on_error(lib, code, "fa_forward")
    launch_counts["causal_flash_attention"] += 1
    return o, lse


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
# Public wrappers
# ---------------------------------------------------------------------------

def causal_flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    dropout_rate: float = 0.0, seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o (BH, N, D) in q's dtype, lse (BH, N, 1) fp32)`` from contiguous
    ``q, k, v (BH, N, D)``.  ``seed`` keys the dropout draw; the CPU path
    draws the same mask as the kernel (:func:`dropout_keep_reference`)."""
    if q.device.type == "cuda":
        return _causal_flash_attention_cuda(q, k, v, dropout_rate, seed)
    if q.device.type != "cpu":
        raise ValueError(f"causal attention takes CPU or CUDA tensors, got {q.device}")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (BH, N, D) shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_dropout(dropout_rate)
    plain_counts["causal_flash_attention"] += 1
    keep = None
    if dropout_rate > 0.0:
        keep = dropout_keep_reference(seed, q.shape[0], q.shape[1], dropout_rate)
    return causal_attention_reference_lse(q, k, v, keep=keep, dropout_rate=dropout_rate)


def causal_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Strictly-causal multi-head attention without the ``(N, N)`` matrix in
    device memory.

    ``q, k, v`` — ``(B, H, N, D)``, fp32 or bf16, any ``N >= 1``, ``D`` a
    multiple of 4 up to 64.  ``dropout_rate > 0`` needs a ``generator``, from
    which the seed of the kernel's counter-based draw is taken.  Returns
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
    flat = [t.reshape(b * h, n, d).contiguous() for t in (q, k, v)]
    o, _ = causal_flash_attention_lse(*flat, dropout_rate=dropout_rate, seed=seed)
    return o.reshape(b, h, n, d)
