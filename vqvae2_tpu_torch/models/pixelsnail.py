"""PixelSNAIL autoregressive prior (port of ``vqvae2_tpu/models/pixelsnail.py``).

Layout: every module here takes and returns what the JAX package's does —
code ids ``(B, H, W)`` int, feature maps ``(B, H, W, C)``, logits
``(B, H, W, n_class)``.  A convolution sees ``x.permute(0, 3, 1, 2)``, a free
NCHW view of the same memory (``channels_last``), and its result is permuted
back; gates, concatenations and ELUs act on the trailing channel axis.

Weight normalisation is written out (``w = g · v / sqrt(Σv² + 1e-12)``, the norm
per output channel) with ``v``, ``g``, ``b`` as the parameters, since
``torch.nn.utils.weight_norm`` has another epsilon and parametrisation.  A
causal convolution's kernel mask is a constant buffer multiplied into ``v``
*before* the norm, so the norm leaves the masked taps out.  ``WNConv.v`` is
``(O, I, kh, kw)``; ``WNDense.v`` stays ``(I, O)`` as in the JAX package and is
applied as ``x @ w`` (``utils/jax_import.py`` holds the maps).

Attention goes through :func:`vqvae2_tpu_torch.ops.causal_flash_attention`:
the hand-written kernel for a CUDA tensor of any length ``N``, the plain
version for a CPU tensor.

Dropout follows the module's mode: in ``train()`` with a rate above zero the
forward needs a ``generator`` (a ``torch.Generator`` on the input's device),
from which every dropout draw of the call is taken — the residual blocks'
Bernoulli masks, and the seed of the attention kernel's counter-based draw on
the probabilities.  In ``eval()`` nothing is drawn.  Inside
:func:`batch_rows` (a data-parallel step) the residual blocks draw the global
batch's masks and keep this rank's rows, as flax's dropout does not depend on
the sharding: the ranks together drop what one process drops.

``dtype`` is the compute type of the convolutions, as in the JAX package: the
weight norm is taken in fp32, then input, kernel and bias are cast to
``dtype`` (``models/layers.py``); the one-hot input and the background are
made in ``dtype``.  ``WNDense`` and ``CausalAttention`` have no ``dtype``
there, so a bf16 input meets fp32 weights and is widened: the attention's
q, k and v are fp32 in either mode, and so is its output.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch.models.layers import cast_conv, promote
from vqvae2_tpu_torch.ops.flash_attention import causal_flash_attention


def _to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Weight-normalized conv/dense: w = g · v / ‖v‖, norm per output channel
# ---------------------------------------------------------------------------

class WNConv(nn.Module):
    """Weight-normalised convolution, ``(B, H, W, C)`` in and out.

    ``padding`` — ``(top, bottom, left, right)`` zeros, applied before a
    convolution without padding of its own (the causal convolutions pad
    asymmetrically).  ``kernel_mask`` — a static ``(kh, kw)`` 0/1 mask.
    ``dtype`` — the compute type."""

    def __init__(self, in_channel: int, features: int, kernel_size: Tuple[int, int],
                 padding: Sequence[int] = (0, 0, 0, 0), use_bias: bool = True,
                 kernel_mask: Optional[np.ndarray] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        kh, kw = kernel_size
        self.padding = tuple(int(p) for p in padding)
        self.dtype = dtype
        # the JAX package draws v from lecun_normal: variance 1 / fan_in
        v = torch.randn(features, in_channel, kh, kw) * (in_channel * kh * kw) ** -0.5
        if kernel_mask is not None:
            self.register_buffer(
                "kernel_mask", torch.as_tensor(np.asarray(kernel_mask), dtype=torch.float32),
                persistent=False)
            masked = v * self.kernel_mask
        else:
            self.kernel_mask = None
            masked = v
        self.v = nn.Parameter(v)
        # g starts at the masked norm, so that w == v at the start
        self.g = nn.Parameter(masked.pow(2).sum(dim=(1, 2, 3)).sqrt())
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None

    def weight(self) -> torch.Tensor:
        """The resolved kernel ``(O, I, kh, kw)``."""
        v = self.v if self.kernel_mask is None else self.v * self.kernel_mask
        norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True) + 1e-12)
        return (self.g[:, None, None, None] / norm) * v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _to_nchw(x)
        if any(self.padding):
            top, bottom, left, right = self.padding
            x = F.pad(x, (left, right, top, bottom))
        return _to_nhwc(cast_conv(F.conv2d, x, self.weight(), self.b, self.dtype))


class WNDense(nn.Module):
    """Weight-normalised dense layer on the trailing axis; ``v`` is ``(I, O)``.
    It has no compute type: a bf16 input is widened to fp32, as JAX promotes
    ``bf16 @ fp32``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        v = torch.randn(in_features, features) * in_features ** -0.5
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(v.pow(2).sum(dim=0).sqrt())
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None

    def weight(self) -> torch.Tensor:
        """The resolved matrix ``(I, O)``."""
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=0, keepdim=True) + 1e-12)
        return (self.g[None, :] / norm) * self.v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight()
        y = promote(x, w) @ w
        return y + self.b if self.b is not None else y


# ---------------------------------------------------------------------------
# Shifts, (B, H, W, C)
# ---------------------------------------------------------------------------

def shift_down(x: torch.Tensor, size: int = 1) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, 0, size, 0))[:, : x.shape[1]]


def shift_right(x: torch.Tensor, size: int = 1) -> torch.Tensor:
    return F.pad(x, (0, 0, size, 0))[:, :, : x.shape[2]]


# ---------------------------------------------------------------------------
# Causal convolution
# ---------------------------------------------------------------------------

def causal_kernel_mask(kh: int, kw: int) -> np.ndarray:
    """Ones, with the last row zeroed from the centre rightward."""
    m = np.ones((kh, kw), np.float32)
    m[-1, kw // 2:] = 0.0
    return m


class CausalConv(WNConv):
    """'downright' pads (top kh−1, left kw−1); 'down' and 'causal' pad top kh−1
    and kw//2 on both sides; 'causal' also masks the kernel's last row from the
    centre rightward, as a static mask."""

    def __init__(self, in_channel: int, features: int, kernel_size: Tuple[int, int],
                 padding_mode: str = "downright", dtype: torch.dtype = torch.float32):
        kh, kw = kernel_size
        if padding_mode == "downright":
            padding = (kh - 1, 0, kw - 1, 0)
        elif padding_mode in ("down", "causal"):
            padding = (kh - 1, 0, kw // 2, kw // 2)
        else:
            raise ValueError(padding_mode)
        mask = causal_kernel_mask(kh, kw) if padding_mode == "causal" else None
        super().__init__(in_channel, features, kernel_size, padding=padding, kernel_mask=mask,
                         dtype=dtype)
        self.padding_mode = padding_mode


# ``(start, total, groups)``: this rank's first row, the global batch's rows
# and its blocks while a data-parallel step runs (set by ``batch_rows``; None
# outside one).
_BATCH_ROWS: ContextVar[Optional[Tuple[int, int, int]]] = ContextVar("batch_rows",
                                                                     default=None)


@contextlib.contextmanager
def batch_rows(start: int, total: int, groups: int = 1):
    """Within the block, this process holds rows ``start:`` of a global batch
    of ``total`` rows: :func:`dropout` draws the ``total`` rows' mask and keeps
    this process's rows.  With ``groups`` the tensors hold that many blocks
    of this process's rows, one after the other, of a global batch of that
    many blocks of ``total`` rows (``parallel.gather_batch``'s layout)."""
    token = _BATCH_ROWS.set((start, total, groups))
    try:
        yield
    finally:
        _BATCH_ROWS.reset(token)


def draw_rows(local: int) -> Tuple[int, int]:
    """``(rows, start)``: how many rows a random draw over the batch takes and
    where this process's ``local`` rows start among them: the global batch's
    inside :func:`batch_rows`, else ``(local, 0)``."""
    rows = _BATCH_ROWS.get()
    return (local, 0) if rows is None else (rows[1], rows[0])


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (``flax.linen.Dropout``): keep with probability
    ``1 - rate`` and scale by ``1 / (1 - rate)``; the draw comes from
    ``generator``, which training with ``rate > 0`` requires.  Inside
    :func:`batch_rows` the mask is the global batch's, cut to this rank's
    rows, and the generator advances as one process's does."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator (pass generator=...)")
    rows = _BATCH_ROWS.get()
    shape = x.shape if rows is None else (rows[2] * rows[1], *x.shape[1:])
    keep = torch.empty(shape, dtype=torch.float32, device=x.device).bernoulli_(
        1.0 - rate, generator=generator)
    if rows is not None:
        start, total, groups = rows
        local = x.shape[0] // groups
        keep = torch.cat([keep[g * total + start:g * total + start + local]
                          for g in range(groups)])
    return torch.where(keep != 0, x / (1.0 - rate), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Gated residual block
# ---------------------------------------------------------------------------

class GatedResBlock(nn.Module):
    """ELU → conv → (+ aux) → ELU → dropout → conv → (+ condition) → GLU, plus
    skip.  ``conv`` ∈ 'wnconv2d' | 'causal_downright' | 'causal'.
    ``aux_channel`` > 0 adds the 1×1 ``aux_conv`` branch (``aux_input``);
    ``condition_dim`` > 0 adds the bias-free 1×1 ``condition`` branch."""

    def __init__(self, in_channel: int, channel: int, kernel_size: int, conv: str = "wnconv2d",
                 dropout: float = 0.1, aux_channel: int = 0, condition_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = self._conv(conv, in_channel, channel, kernel_size, dtype)
        self.aux_conv = (WNConv(aux_channel, channel, (1, 1), dtype=dtype)
                         if aux_channel > 0 else None)
        self.dropout = dropout
        self.conv2 = self._conv(conv, channel, in_channel * 2, kernel_size, dtype)
        self.condition = (WNConv(condition_dim, in_channel * 2, (1, 1), use_bias=False,
                                 dtype=dtype)
                          if condition_dim > 0 else None)

    @staticmethod
    def _conv(conv: str, in_channel: int, features: int, k: int, dtype: torch.dtype) -> WNConv:
        if conv == "wnconv2d":
            return WNConv(in_channel, features, (k, k), padding=(k // 2,) * 4, dtype=dtype)
        if conv == "causal_downright":
            return CausalConv(in_channel, features, (k, k), "downright", dtype=dtype)
        if conv == "causal":
            return CausalConv(in_channel, features, (k, k), "causal", dtype=dtype)
        raise ValueError(conv)

    def forward(self, x: torch.Tensor, aux_input: Optional[torch.Tensor] = None,
                condition: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.conv1(F.elu(x))
        if aux_input is not None:
            out = out + self.aux_conv(F.elu(aux_input))
        out = dropout(F.elu(out), self.dropout, self.training, generator)
        out = self.conv2(out)
        if condition is not None:
            out = out + self.condition(condition)
        a, b = out.chunk(2, dim=-1)
        return x + a * torch.sigmoid(b)      # GLU gate + residual


# ---------------------------------------------------------------------------
# Causal attention
# ---------------------------------------------------------------------------

class CausalAttention(nn.Module):
    """Strictly-causal multi-head attention over the raster order of the grid.

    The scores, softmax, dropout and weighted sum run in
    :func:`~vqvae2_tpu_torch.ops.flash_attention.causal_flash_attention`; for
    a CUDA tensor that is the hand-written kernel for every ``N >= 1``, and
    its gradient the two backward kernels.  In ``train()`` the probabilities
    are dropped at ``dropout`` with a seed drawn from ``generator``."""

    def __init__(self, query_channel: int, key_channel: int, channel: int, n_head: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.channel, self.n_head, self.dropout = channel, n_head, dropout
        self.query = WNDense(query_channel, channel)
        self.key = WNDense(key_channel, channel)
        self.value = WNDense(key_channel, channel)

    def qkv(self, query: torch.Tensor, key: torch.Tensor):
        """``q, k, v (B, n_head, N, dim_head)``, contiguous."""
        b, h, w, _ = key.shape
        n = h * w

        def heads(t):
            return t.reshape(b, n, self.n_head, self.channel // self.n_head) \
                    .transpose(1, 2).contiguous()

        return (heads(self.query(query.reshape(b, n, -1))),
                heads(self.key(key.reshape(b, n, -1))),
                heads(self.value(key.reshape(b, n, -1))))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = key.shape
        rate = self.dropout if self.training else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("dropout in train mode needs a generator (pass generator=...)")
        out = causal_flash_attention(*self.qkv(query, key), dropout_rate=rate,
                                     generator=generator)
        return out.transpose(1, 2).reshape(b, h, w, self.channel)


# ---------------------------------------------------------------------------
# PixelBlock / CondResNet / PixelSNAIL
# ---------------------------------------------------------------------------

class PixelBlock(nn.Module):
    def __init__(self, channel: int, res_channel: int, kernel_size: int, n_res_block: int,
                 attention: bool = True, dropout: float = 0.1, condition_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(dropout=dropout, dtype=dtype)
        self.res = nn.ModuleList([
            GatedResBlock(channel, res_channel, kernel_size, conv="causal",
                          condition_dim=condition_dim, **dt)
            for _ in range(n_res_block)])
        self.attention = attention
        if attention:
            self.key_resblock = GatedResBlock(channel * 2 + 2, channel, 1, **dt)
            self.query_resblock = GatedResBlock(channel + 2, channel, 1, **dt)
            self.causal_attention = CausalAttention(
                channel + 2, channel * 2 + 2, channel // 2, dropout=dropout)
            self.out_resblock = GatedResBlock(channel, channel, 1, aux_channel=channel // 2,
                                              **dt)
        else:
            self.out = WNConv(channel + 2, channel, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor, background: torch.Tensor,
                condition: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = x
        for res in self.res:
            out = res(out, condition=condition, generator=generator)
        if self.attention:
            key = self.key_resblock(torch.cat([x, out, background], dim=-1), generator=generator)
            query = self.query_resblock(torch.cat([out, background], dim=-1),
                                        generator=generator)
            attn_out = self.causal_attention(query, key, generator=generator)
            return self.out_resblock(out, aux_input=attn_out, generator=generator)
        return self.out(torch.cat([out, background], dim=-1))


class CondResNet(nn.Module):
    def __init__(self, in_channel: int, channel: int, kernel_size: int, n_res_block: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = kernel_size
        self.conv_in = WNConv(in_channel, channel, (k, k), padding=(k // 2,) * 4, dtype=dtype)
        self.res = nn.ModuleList([GatedResBlock(channel, channel, k, dtype=dtype)
                                  for _ in range(n_res_block)])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv_in(x)
        for res in self.res:
            x = res(x, generator=generator)
        return x


def _background(height: int, width: int) -> np.ndarray:
    """Coordinate channels ``(H, W, 2)``: rows then columns, centred and scaled
    to [-0.5, 0.5)."""
    cx = ((np.arange(height, dtype=np.float32) - height / 2) / height)[:, None]
    cy = ((np.arange(width, dtype=np.float32) - width / 2) / width)[None, :]
    return np.stack(
        [np.broadcast_to(cx, (height, width)), np.broadcast_to(cy, (height, width))],
        axis=-1,
    )


class PixelSNAIL(nn.Module):
    """``shape``: code grid (H, W); ``n_class``: codebook size.  Top prior:
    attention on, unconditional.  Bottom prior: attention off, conditioned on
    the top codes (``n_cond_res_block > 0``).  ``dtype`` — the compute type
    of the convolutions; the logits come out in it."""

    def __init__(self, shape: Tuple[int, int], n_class: int = 512, channel: int = 256,
                 kernel_size: int = 5, n_block: int = 4, n_res_block: int = 4,
                 res_channel: int = 256, attention: bool = True, dropout: float = 0.1,
                 n_cond_res_block: int = 0, cond_res_channel: int = 0,
                 cond_res_kernel: int = 3, n_out_res_block: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = dict(
            shape=tuple(shape), n_class=n_class, channel=channel, kernel_size=kernel_size,
            n_block=n_block, n_res_block=n_res_block, res_channel=res_channel,
            attention=attention, dropout=dropout, n_cond_res_block=n_cond_res_block,
            cond_res_channel=cond_res_channel, cond_res_kernel=cond_res_kernel,
            n_out_res_block=n_out_res_block)
        self.shape = tuple(shape)
        self.n_class, self.channel, self.kernel_size = n_class, channel, kernel_size
        self.n_block, self.n_res_block, self.res_channel = n_block, n_res_block, res_channel
        self.attention, self.n_out_res_block = attention, n_out_res_block
        self.dtype = dtype

        kernel = kernel_size + (kernel_size % 2 == 0)
        self.horizontal = CausalConv(n_class, channel, (kernel // 2, kernel), "down", dtype=dtype)
        self.vertical = CausalConv(n_class, channel, ((kernel + 1) // 2, kernel // 2),
                                   "downright", dtype=dtype)
        self.blocks = nn.ModuleList([
            PixelBlock(channel, res_channel, kernel_size, n_res_block, attention=attention,
                       dropout=dropout, condition_dim=cond_res_channel, dtype=dtype)
            for _ in range(n_block)])
        self.cond_resnet = (CondResNet(n_class, cond_res_channel, cond_res_kernel,
                                       n_cond_res_block, dtype=dtype)
                            if n_cond_res_block > 0 else None)
        self.out_res = nn.ModuleList([GatedResBlock(channel, res_channel, 1, dtype=dtype)
                                      for _ in range(n_out_res_block)])
        self.out_conv = WNConv(channel, n_class, (1, 1), dtype=dtype)
        self.register_buffer("background", torch.from_numpy(_background(*self.shape).copy()),
                             persistent=False)

    def forward(self, codes: torch.Tensor, condition: Optional[torch.Tensor] = None,
                condition_features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``codes (B, H, W)`` int → logits ``(B, H, W, n_class)``.  ``condition``
        — ``(B, Hc, Wc)`` int codes of the grid above, or ``condition_features``
        — what :meth:`compute_condition` made of them.  ``generator`` feeds the
        dropout draws in ``train()``."""
        b, height, width = codes.shape
        x = F.one_hot(codes.long(), self.n_class).to(self.dtype)
        out = shift_down(self.horizontal(x)) + shift_right(self.vertical(x))
        background = self.background[:height, :width].to(self.dtype).expand(b, height, width, 2)

        cond = condition_features
        if cond is None and condition is not None:
            cond = self.compute_condition(condition, generator=generator)
        if cond is not None:
            cond = cond[:, :height, :width]

        for block in self.blocks:
            out = block(out, background, condition=cond, generator=generator)
        for res in self.out_res:
            out = res(out, generator=generator)
        return self.out_conv(F.elu(out))

    def compute_condition(self, condition: torch.Tensor,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CondResNet and a 2× nearest upsample; call once per sample run and
        pass the result as ``condition_features``."""
        c = F.one_hot(condition.long(), self.n_class).to(self.dtype)
        c = self.cond_resnet(c, generator=generator)
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

