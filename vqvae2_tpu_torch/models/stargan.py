"""StarGAN v2 model family (port of ``vqvae2_tpu/models/stargan.py``): the
hourglass generator with its skip cache and high-pass injection, the mapping
network, the style encoder, the multi-domain image discriminator and
``ModelStarGAN``, a pair of generators driven by person features through the
mapping network.

Every public function takes and returns ``(B, H, W, C)``, the images with
three channels; inside a module the permutes to NCHW are views
(``channels_last`` memory).  Only the variables flax creates exist, under flax's names where they are not lists: ``enc<i>``,
``dec<i>``, ``enc_bottleneck<i>``, ``dec_bottleneck<i>``, ``blk<i>`` and
``shared<i>`` are the port's ``enc.<i>``, ...; a mapping network's
``dom<d>_<i>`` / ``dom<d>_out`` are ``dom.<d>.<i>`` / ``dom_out.<d>``; the
unnamed ``Conv_0`` / ``Conv_1`` / ``Conv_2`` of the style encoder and the
discriminator are ``conv_in`` / ``conv_out`` / ``head``
(:func:`vqvae2_tpu_torch.utils.jax_import.stargan_from_jax`).

An ``AdainResBlkV2`` with ``w_hpf > 0`` returns its residual branch alone;
its ``conv1x1`` shortcut still has parameters (flax creates them, their
gradient is zero) but is not computed.  ``ModelStarGAN(remat=True)``, the
default as in the JAX package, recomputes each generator's and the
discriminator's activations in the backward (``torch.utils.checkpoint``,
``use_reentrant=False``, which also carries R1's gradient of a gradient).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vqvae2_tpu_torch.models.embed_net import EmbedNet
from vqvae2_tpu_torch.models.layers import Conv2d, lecun_normal_
from vqvae2_tpu_torch.models.resnet import Dense, pool_dim
from vqvae2_tpu_torch.models.vqvae_deep import AdaIN
from vqvae2_tpu_torch.part.part_model import _resize


def _conv(c_in: int, c_out: int, k: int, padding: int = 0, bias: bool = True,
          dtype: torch.dtype = torch.float32) -> Conv2d:
    """An NCHW convolution with flax's initialisers (LeCun normal, zero bias)."""
    conv = Conv2d(c_in, c_out, k, padding=padding, bias=bias, dtype=dtype)
    lecun_normal_(conv.weight)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)
    return conv


def _instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, eps: float = 1e-5) -> torch.Tensor:
    """Per sample and channel over H, W of NCHW (population variance)."""
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, correction=0)
    y = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale[:, None, None] + bias[:, None, None]
    return y


def _up2(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` to twice the size."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlk(nn.Module):
    """Pre-activation residual block with 1/sqrt(2) scaling, optional
    instance norms (``in<k>_scale``, ``in<k>_bias``) and 2x2 average-pool
    downsampling.  NCHW."""

    def __init__(self, dim_in: int, dim_out: int, normalize: bool = False,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize, self.downsample = normalize, downsample
        if dim_in != dim_out:
            self.conv1x1 = _conv(dim_in, dim_out, 1, bias=False, dtype=dtype)
        if normalize:
            self.in1_scale = nn.Parameter(torch.ones(dim_in))
            self.in1_bias = nn.Parameter(torch.zeros(dim_in))
            self.in2_scale = nn.Parameter(torch.ones(dim_in))
            self.in2_bias = nn.Parameter(torch.zeros(dim_in))
        self.conv1 = _conv(dim_in, dim_in, 3, padding=1, dtype=dtype)
        self.conv2 = _conv(dim_in, dim_out, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.conv1x1(x) if hasattr(self, "conv1x1") else x
        if self.downsample:
            sc = F.avg_pool2d(sc, 2)
        h = _instance_norm(x, self.in1_scale, self.in1_bias) if self.normalize else x
        h = self.conv1(F.leaky_relu(h, 0.2))
        if self.downsample:
            h = F.avg_pool2d(h, 2)
        if self.normalize:
            h = _instance_norm(h, self.in2_scale, self.in2_bias)
        h = self.conv2(F.leaky_relu(h, 0.2))
        return (sc + h) / math.sqrt(2)


class AdainResBlkV2(nn.Module):
    """Style-conditioned residual block: AdaIN -> lrelu -> (x2 nearest) ->
    3x3 -> AdaIN -> lrelu -> 3x3; with ``w_hpf == 0`` plus the shortcut over
    sqrt(2), else the branch alone.  NCHW."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int, w_hpf: int = 0,
                 upsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_hpf, self.upsample = w_hpf, upsample
        if dim_in != dim_out:
            self.conv1x1 = _conv(dim_in, dim_out, 1, bias=False, dtype=dtype)
        self.norm1 = AdaIN(style_dim, dim_in, dtype)
        self.conv1 = _conv(dim_in, dim_out, 3, padding=1, dtype=dtype)
        self.norm2 = AdaIN(style_dim, dim_out, dtype)
        self.conv2 = _conv(dim_out, dim_out, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.norm1(x, s), 0.2)
        if self.upsample:
            h = _up2(h)
        h = F.leaky_relu(self.norm2(self.conv1(h), s), 0.2)
        h = self.conv2(h)
        if self.w_hpf != 0:
            return h
        sc = _up2(x) if self.upsample else x
        if hasattr(self, "conv1x1"):
            sc = self.conv1x1(sc)
        return (h + sc) / math.sqrt(2)


def high_pass(x: torch.Tensor, w_hpf: float) -> torch.Tensor:
    """The depthwise 3x3 Laplacian divided by ``w_hpf``, zero padded; NCHW."""
    c = x.shape[1]
    k = np.asarray([[-1, -1, -1], [-1, 8.0, -1], [-1, -1, -1]], np.float32) / w_hpf
    kernel = torch.from_numpy(k).to(x.device, x.dtype).expand(c, 1, 3, 3)
    return F.conv2d(x, kernel, padding=1, groups=c)


class Generator(nn.Module):
    """The hourglass generator: ``from_rgb``, ``repeat_num`` downsampling
    ``ResBlk``s (one more with ``w_hpf > 0``), two bottleneck ``ResBlk``s, two
    bottleneck and ``repeat_num`` upsampling ``AdainResBlkV2``s, then an
    instance norm, lrelu and the 1x1 ``to_rgb`` to ``out_channel``.  With
    ``masks`` the encoder's maps at heights 32, 64 and 128 are kept and added
    back, masked (resized bilinearly, antialiased) and high-passed, after the
    decoder block of the same height."""

    def __init__(self, img_size: int = 128, style_dim: int = 64, max_conv_dim: int = 512,
                 w_hpf: int = 1, out_channel: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.w_hpf = img_size, w_hpf
        dim_in = 2 ** 14 // img_size
        self.repeat_num = int(np.log2(img_size)) - 4 + (1 if w_hpf > 0 else 0)
        dims = [dim_in]
        for _ in range(self.repeat_num):
            dims.append(min(dims[-1] * 2, max_conv_dim))
        self.from_rgb = _conv(3, dim_in, 3, padding=1, dtype=dtype)
        self.enc = nn.ModuleList([ResBlk(dims[i], dims[i + 1], normalize=True, downsample=True,
                                         dtype=dtype) for i in range(self.repeat_num)])
        self.enc_bottleneck = nn.ModuleList([ResBlk(dims[-1], dims[-1], normalize=True,
                                                    dtype=dtype) for _ in range(2)])
        self.dec_bottleneck = nn.ModuleList([AdainResBlkV2(dims[-1], dims[-1], style_dim, w_hpf,
                                                           dtype=dtype) for _ in range(2)])
        # dec[i] takes dims[i + 1] (the block above it) to dims[i]
        self.dec = nn.ModuleList([AdainResBlkV2(dims[i + 1], dims[i], style_dim, w_hpf,
                                                upsample=True, dtype=dtype)
                                  for i in range(self.repeat_num)])
        self.to_rgb_in_scale = nn.Parameter(torch.ones(dim_in))
        self.to_rgb_in_bias = nn.Parameter(torch.zeros(dim_in))
        self.to_rgb = _conv(dim_in, out_channel, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        div = 1 << self.repeat_num
        if x.shape[1] % div or x.shape[2] % div:
            # Stride-2 SAME floors the odd side going down and x2 upsampling
            # cannot recover it, so the output would come back the wrong size.
            raise ValueError(
                f"Generator(img_size={self.img_size}) runs {self.repeat_num} "
                f"stride-2 stages; input {x.shape[1]}x{x.shape[2]} must be "
                f"divisible by {div} (use a smaller img_size)")
        h = self.from_rgb(x.permute(0, 3, 1, 2))
        cache = {}
        for blk in self.enc:
            if masks is not None and h.shape[2] in (32, 64, 128):
                cache[h.shape[2]] = h
            h = blk(h)
        for blk in self.enc_bottleneck:
            h = blk(h)
        for blk in self.dec_bottleneck:
            h = blk(h, s)
        for i in reversed(range(self.repeat_num)):
            h = self.dec[i](h, s)
            if masks is not None and h.shape[2] in (32, 64, 128):
                hh, ww = h.shape[2:]
                mask = masks[0] if hh == 32 else masks[1]
                mask = _resize(mask, (hh, ww)).permute(0, 3, 1, 2)
                h = h + high_pass(mask * cache[hh], self.w_hpf)
        h = _instance_norm(h, self.to_rgb_in_scale, self.to_rgb_in_bias)
        return self.to_rgb(F.leaky_relu(h, 0.2)).permute(0, 2, 3, 1)


def _take(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``out[b, y[b]]`` of ``(B, num_domains, ...)``."""
    return out[torch.arange(out.shape[0], device=out.device), y.long()]


class MappingNetwork(nn.Module):
    """Latent -> per-domain style: four shared ReLU dense layers of 512, then
    per domain three more and a linear one to ``style_dim``; the domain
    ``y`` picks the row."""

    def __init__(self, latent_dim: int, style_dim: int = 64, num_domains: int = 2):
        super().__init__()
        self.shared = nn.ModuleList([Dense(latent_dim if i == 0 else 512, 512)
                                     for i in range(4)])
        self.dom = nn.ModuleList([nn.ModuleList([Dense(512, 512) for _ in range(3)])
                                  for _ in range(num_domains)])
        self.dom_out = nn.ModuleList([Dense(512, style_dim) for _ in range(num_domains)])

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = z
        for layer in self.shared:
            h = F.relu(layer(h))
        outs = []
        for layers, out in zip(self.dom, self.dom_out):
            g = h
            for layer in layers:
                g = F.relu(layer(g))
            outs.append(out(g))
        return _take(torch.stack(outs, dim=1), y)


class _DownNet(nn.Module):
    """``conv_in`` (3x3), ``log2(img_size) - 2`` downsampling ``ResBlk``s,
    lrelu, ``conv_out`` (4x4 valid), lrelu: the trunk the style encoder and the
    discriminator share.  ``(B, H, W, C)`` in, NCHW out."""

    def __init__(self, img_size: int, max_conv_dim: int, dtype):
        super().__init__()
        dim_in = 2 ** 14 // img_size
        self.conv_in = _conv(3, dim_in, 3, padding=1, dtype=dtype)
        blocks = []
        for _ in range(int(np.log2(img_size)) - 2):
            dim_out = min(dim_in * 2, max_conv_dim)
            blocks.append(ResBlk(dim_in, dim_out, downsample=True, dtype=dtype))
            dim_in = dim_out
        self.blk = nn.ModuleList(blocks)
        self.conv_out = _conv(dim_in, dim_in, 4, dtype=dtype)
        self.dim_out = dim_in

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.permute(0, 3, 1, 2))
        for blk in self.blk:
            h = blk(h)
        return F.leaky_relu(self.conv_out(F.leaky_relu(h, 0.2)), 0.2)


class StyleEncoder(_DownNet):
    """Image -> per-domain style: the trunk, its spatial mean, one dense
    layer a domain; ``y`` picks the row."""

    def __init__(self, img_size: int = 128, style_dim: int = 64, num_domains: int = 2,
                 max_conv_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__(img_size, max_conv_dim, dtype)
        self.dom = nn.ModuleList([Dense(self.dim_out, style_dim) for _ in range(num_domains)])

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = torch.mean(self.trunk(x), dim=(2, 3))
        return _take(torch.stack([d(h) for d in self.dom], dim=1), y)


class DiscriminatorV2(_DownNet):
    """Multi-domain image discriminator: the trunk, a 1x1 ``head`` to one
    logit a domain, its spatial mean; ``y`` picks the logit.  ``(B,)``."""

    def __init__(self, img_size: int = 128, num_domains: int = 2, max_conv_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__(img_size, max_conv_dim, dtype)
        self.head = _conv(self.dim_out, num_domains, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = torch.mean(self.head(self.trunk(x)), dim=(2, 3))
        return _take(h, y)


class ModelStarGAN(nn.Module):
    """Two generators (gray -> IR: ``gen_1``, domain 0; IR -> gray: ``gen_2``,
    domain 1) whose style is the mapping network's of a person feature, the
    ReID net ``EmbedNet(class_num, arch)`` that gives those features, and the
    two-domain discriminator.  ``remat`` recomputes the generators' and the
    discriminator's activations in the backward."""

    def __init__(self, class_num: int, arch: str = "resnet18", img_size: int = 128,
                 remat: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.person_id = EmbedNet(class_num, arch=arch)
        self.mapping = MappingNetwork(pool_dim(arch), 512, 2)
        self.adaptor1 = Generator(img_size, 512, dtype=dtype)
        self.adaptor2 = Generator(img_size, 512, dtype=dtype)
        self.discriminator = DiscriminatorV2(img_size, 2, dtype=dtype)

    def _run(self, module: nn.Module, *args) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False)
        return module(*args)

    def encode_person(self, rgb: torch.Tensor):
        return self.person_id(xRGB=rgb, modal=1, with_feature=True)

    def gen_1(self, img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        y = torch.zeros((s.shape[0],), dtype=torch.int64, device=s.device)
        return self._run(self.adaptor1, img, self.mapping(s, y))

    def gen_2(self, img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        y = torch.ones((s.shape[0],), dtype=torch.int64, device=s.device)
        return self._run(self.adaptor2, img, self.mapping(s, y))

    def discriminate(self, img: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self._run(self.discriminator, img, y)

    def forward(self, img: torch.Tensor, s: torch.Tensor):
        return self.gen_1(img, s), self.gen_2(img, s)
