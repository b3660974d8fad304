"""Layers shared by the models (port of the part of
``vqvae2_tpu/models/layers.py`` the ported paths use): L2 ``Normalize``, GeM
pooling and global average pooling on ``(B, H, W, C)``, and the convolutions
with a compute ``dtype`` that every model builds on.  The rest of that file
(spectral-norm convolutions, instance norm, the cross-attention non-local
block, MLPs, the discriminator) belongs to the adaptation and GAN models, not
ported yet.

The compute ``dtype`` is flax's: ``flax.linen.Conv(dtype=bf16)`` casts its
input, kernel and bias to bf16, rounds the product to bf16 and adds the bias
to the rounded product.  The parameters stay fp32.  A module without a
``dtype`` in the JAX package (``nn.BatchNorm()``, ``nn.Dense()``) keeps its
fp32 parameters and promotes a bf16 input to fp32 (:func:`promote`)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def cast_conv(conv: Callable, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``conv(x, weight, bias)`` in ``dtype`` as flax computes it: in fp32 the
    bias is fused into the convolution (one rounding of an fp32 sum); in any
    other dtype the bias is added after the product has rounded to ``dtype``,
    as flax does, which a fused bias would round once instead of twice."""
    if dtype == torch.float32:
        return conv(x, weight, bias)
    y = conv(x.to(dtype), weight.to(dtype), None)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


def promote(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` widened to the type JAX promotes ``x`` and ``weight`` to (a bf16
    input meets fp32 parameters in fp32); PyTorch's matmul raises on mixed
    types instead."""
    return x.to(torch.promote_types(x.dtype, weight.dtype))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on NCHW computing in ``dtype`` (:func:`cast_conv`); the
    parameters stay fp32.  ``dtype`` is flax's compute type, not PyTorch's
    parameter type."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cast_conv(self._conv_forward, x, self.weight, self.bias, self.dtype)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` on NCHW computing in ``dtype`` (:func:`cast_conv`)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv(x, weight, bias):
            return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                      self.output_padding, self.groups, self.dilation)

        return cast_conv(conv, x, self.weight, self.bias, self.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, power: int = 2) -> torch.Tensor:
    """``x / (sum |x|^p)^(1/p)`` along ``dim`` (reference ``Normalize``)."""
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), power), dim=dim, keepdim=True),
                     1.0 / power)
    return x / norm


def gem_pool(x: torch.Tensor, p: float = 3.0, eps: float = 1e-12) -> torch.Tensor:
    """Generalized-mean pooling: ``(mean(x^p) + eps)^(1/p)`` over the spatial
    dims, ``(B, H, W, C) -> (B, C)``."""
    return torch.pow(torch.mean(torch.pow(x, p), dim=(1, 2)) + eps, 1.0 / p)


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average over the spatial dims, ``(B, H, W, C) -> (B, C)``."""
    return torch.mean(x, dim=(1, 2))
