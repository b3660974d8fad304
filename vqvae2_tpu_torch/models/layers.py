"""Layers shared by the models (port of ``vqvae2_tpu/models/layers.py``): the
convolutions with a compute ``dtype`` that every model builds on, the
feature-norm mask, L2 ``Normalize``, GeM and average pooling, the
spectral-norm convolutions, instance norm, the spectral-norm residual block,
``LinearBlock`` / ``MLP`` / ``Discriminator`` and the cross-attention
``NonLocal`` fusion.  Every module from ``compute_mask`` on takes and returns
``(B, H, W, C)``.

Spectral norm is flax's ``nn.SpectralNorm``, not ``torch.nn.utils.
spectral_norm``: the weight as flax lays it out, reshaped to ``(-1, out)``,
takes one power-iteration step from the stored ``u`` at *every* call (torch's
skips it in eval mode), ``u`` and ``v`` are normalised by ``x *
rsqrt(sum(x^2) + 1e-12)`` and carry no gradient while ``sigma = v W u^T``
does, and ``u`` and ``sigma`` are written back only when ``update_stats``.

The compute ``dtype`` is flax's: ``flax.linen.Conv(dtype=bf16)`` casts its
input, kernel and bias to bf16, rounds the product to bf16 and adds the bias
to the rounded product.  The parameters stay fp32.  A module without a
``dtype`` in the JAX package (``nn.BatchNorm()``, ``nn.Dense()``) keeps its
fp32 parameters and promotes a bf16 input to fp32 (:func:`promote`)."""

from __future__ import annotations

import math
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


def cast_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    """``F.linear`` in ``dtype`` as flax's ``Dense(dtype=...)`` computes it
    (:func:`cast_conv`'s rule: in bf16 the bias is added to the rounded
    product)."""
    if dtype == torch.float32:
        return F.linear(promote(x, weight), weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def compute_mask(feat: torch.Tensor) -> torch.Tensor:
    """Attention mask from feature norms: the per-pixel L2 norm over channels,
    min-max normalised per sample (``+ 1e-12``), detached.  ``(B, H, W, C) ->
    (B, H, W, 1)``."""
    b, h, w, _ = feat.shape
    norms = torch.linalg.vector_norm(feat, dim=-1).reshape(b, h * w)
    norms = norms - torch.amin(norms, dim=-1, keepdim=True)
    norms = norms / (torch.amax(norms, dim=-1, keepdim=True) + 1e-12)
    return norms.reshape(b, h, w, 1).detach()


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """flax's ``_l2_normalize`` over the whole tensor."""
    return x * torch.rsqrt(torch.sum(x * x) + eps)


# flax's default kernel initialiser (LeCun normal: a normal truncated at two
# standard deviations, scaled to variance 1 / fan_in)
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax's LeCun normal in place; ``fan_in`` defaults to that of a
    ``Conv2d`` or ``Linear`` weight ``(out, in, ...)``."""
    if fan_in is None:
        fan_in = weight.shape[1] * math.prod(weight.shape[2:]) if weight.ndim > 1 else 1
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


class _SpectralNormConv(nn.Module):
    """A convolution whose weight is divided by its largest singular value,
    estimated as flax's ``nn.SpectralNorm`` does (module docstring).  The
    buffers ``u`` ``(1, out)`` and ``sigma`` ``()`` are flax's ``batch_stats``
    of the wrapper."""

    transposed = False

    def __init__(self, weight_shape, features: int, fan_in: int, use_bias: bool,
                 dtype: torch.dtype, eps: float = 1e-12):
        super().__init__()
        self.features, self.dtype, self.eps = features, dtype, eps
        self.weight = nn.Parameter(lecun_normal_(torch.empty(weight_shape), fan_in))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("u", torch.randn(1, features))
        self.register_buffer("sigma", torch.ones(()))

    def _flax_matrix(self) -> torch.Tensor:
        """The weight as flax's kernel ``(kh, kw, in, out)``, reshaped to
        ``(-1, out)``."""
        w = self.weight
        kernel = w.flip(2, 3).permute(2, 3, 0, 1) if self.transposed else w.permute(2, 3, 1, 0)
        return kernel.reshape(-1, self.features)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        mat = self._flax_matrix()
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.t(), self.eps)
            u = _l2_normalize(v @ mat, self.eps)
        sigma = ((v @ mat) @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


def same_pads(size: int, kernel: int, stride: int):
    """flax's ``"SAME"`` pad of one spatial axis, (low, high): the total pad
    split with the smaller half first, so a strided convolution may pad (0, 1)
    where PyTorch's ``padding=1`` pads (1, 1)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SNConv(_SpectralNormConv):
    """Spectral-norm convolution with flax's ``"SAME"`` padding, ``(B, H, W,
    C)`` in and out."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1, stride: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__((features, in_features, kernel_size, kernel_size), features,
                         kernel_size * kernel_size * in_features, use_bias, dtype)
        self.kernel_size, self.stride = kernel_size, stride

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        weight = self.normalized_weight(update_stats)
        k, s = self.kernel_size, self.stride
        pads = [*same_pads(x.shape[2], k, s), *same_pads(x.shape[1], k, s)]   # W, then H
        x = F.pad(x.permute(0, 3, 1, 2), pads)
        y = cast_conv(lambda a, w, b: F.conv2d(a, w, b, s), x, weight, self.bias, self.dtype)
        return y.permute(0, 2, 3, 1)


class SNConvTranspose(_SpectralNormConv):
    """Spectral-norm transposed convolution (4x4, stride 2, flax's ``"SAME"``:
    twice the input's size), ``(B, H, W, C)`` in and out; the weight is
    ``ConvTranspose2d``'s ``(in, out, kh, kw)``."""

    transposed = True

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__((in_features, features, 4, 4), features, 16 * in_features, True, dtype)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        weight = self.normalized_weight(update_stats)

        def conv(a, w, b):
            return F.conv_transpose2d(a, w, b, stride=2, padding=1)

        return cast_conv(conv, x.permute(0, 3, 1, 2), weight, self.bias,
                         self.dtype).permute(0, 2, 3, 1)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over the spatial dims (the
    population variance, eps 1e-5), with an affine ``weight`` and ``bias``
    (flax's ``scale`` and ``bias``)."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(features)) if affine else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=(1, 2), keepdim=True)
        var = torch.var(x, dim=(1, 2), keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight + self.bias
        return y


class ResidualBlock(nn.Module):
    """Spectral-norm 3x3 (no bias) -> instance norm -> ReLU -> spectral-norm
    3x3 -> instance norm, plus the skip."""

    def __init__(self, dim_out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = SNConv(dim_out, dim_out, 3, use_bias=False, dtype=dtype)
        self.in1 = InstanceNorm(dim_out)
        self.conv2 = SNConv(dim_out, dim_out, 3, use_bias=False, dtype=dtype)
        self.in2 = InstanceNorm(dim_out)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        h = F.relu(self.in1(self.conv1(x, update_stats)))
        return x + self.in2(self.conv2(h, update_stats))


class LinearBlock(nn.Module):
    """Dense + activation: relu | lrelu (0.2) | prelu (one slope, from 0.25) |
    selu | tanh | none."""

    ACTIVATIONS = ("relu", "lrelu", "prelu", "selu", "tanh", "none")

    def __init__(self, in_features: int, features: int, activation: str = "relu"):
        super().__init__()
        if activation not in self.ACTIVATIONS:
            raise ValueError(f"unsupported activation {activation}")
        self.activation = activation
        self.dense = nn.Linear(in_features, features)
        lecun_normal_(self.dense.weight)
        nn.init.zeros_(self.dense.bias)
        if activation == "prelu":
            self.prelu_a = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense(promote(x, self.dense.weight))
        act = self.activation
        if act == "relu":
            return F.relu(x)
        if act == "lrelu":
            return F.leaky_relu(x, 0.2)
        if act == "prelu":
            return torch.where(x >= 0, x, self.prelu_a * x)
        if act == "selu":
            return F.selu(x)
        if act == "tanh":
            return torch.tanh(x)
        return x


class MLP(nn.Module):
    """``n_blk`` LinearBlocks over the flattened input, the last one linear."""

    def __init__(self, in_features: int, output_dim: int, dim: int = 512, n_blk: int = 2,
                 activ: str = "relu"):
        super().__init__()
        blocks = [LinearBlock(in_features, dim, activ)]
        blocks += [LinearBlock(dim, dim, activ) for _ in range(n_blk - 2)]
        blocks.append(LinearBlock(dim, output_dim, "none"))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for blk in self.blocks:
            x = blk(x)
        return x


class Discriminator(nn.Module):
    """Feature-space discriminator: an MLP ``d_in -> dim -> d_out`` over pooled
    features (the trainers use ``d_out = 2 * class_num``)."""

    def __init__(self, d_in: int, d_out: int, dim: int = 512):
        super().__init__()
        self.mlp = MLP(d_in, d_out, dim, n_blk=2, activ="relu")

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.mlp(feat)


class NonLocal(nn.Module):
    """Cross-attention fusion of a content map ``c`` with a style map ``s``:
    ``softmax(theta(c) phi(s)^T / n) g(s)`` with ``n`` the number of keys
    (divided before the softmax), then a 1x1 ``W_conv`` and a flax batch norm
    whose scale and bias start at zero (the block starts as the identity),
    plus ``c``.  ``inter = c_features // reduc_ratio``."""

    def __init__(self, c_features: int, s_features: int, reduc_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        from vqvae2_tpu_torch.models.resnet import BatchNorm, Conv2d   # resnet builds on this module

        self.inter = max(c_features // reduc_ratio, 1)
        self.g = Conv2d(s_features, self.inter, 1, dtype=dtype)
        self.theta = Conv2d(c_features, self.inter, 1, dtype=dtype)
        self.phi = Conv2d(s_features, self.inter, 1, dtype=dtype)
        self.W_conv = Conv2d(self.inter, c_features, 1, dtype=dtype)
        self.W_bn = BatchNorm(c_features, scale_init=0.0)

    def forward(self, c: torch.Tensor, s: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, hc, wc, _ = c.shape
        g_s = self.g(s).reshape(b, -1, self.inter)
        theta_c = self.theta(c).reshape(b, hc * wc, self.inter)
        phi_s = self.phi(s).reshape(b, -1, self.inter)
        f = torch.einsum("bqi,bki->bqk", theta_c, phi_s)
        attn = torch.softmax(f / f.shape[-1], dim=-1)
        y = torch.einsum("bqk,bki->bqi", attn, g_s).reshape(b, hc, wc, self.inter)
        return self.W_bn(self.W_conv(y), train=train) + c
