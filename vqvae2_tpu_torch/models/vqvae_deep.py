"""Deep two-level VQ-VAE with AdaIN style injection (port of
``vqvae2_tpu/models/vqvae_deep.py``).

Against :mod:`vqvae2_tpu_torch.models.vqvae`: the encoder takes strides 2, 4,
6 (2x then 4x, the SYSU person-crop geometry) and 8; the decoder's residual
blocks are :class:`AdainResBlk` driven by a style vector when ``style_dim >
0``; ``forward`` returns ``(dec, diff, quant)`` and ``encode`` / ``quantize``
are split, so the adaptation models fuse person features into the latents
between the two.

Layout as in :mod:`~vqvae2_tpu_torch.models.vqvae`: ``(B, H, W, C)`` at every
public function, NCHW views inside.  Parameter names are the original PyTorch
reference's: an encoder is one ``blocks`` Sequential; a decoder has ``conv1``,
``blocks.<j>`` (``ResBlock``: ``conv.1``, ``conv.3``; ``AdainResBlk``:
``norm1.fc``, ``conv1``, ``norm2.fc``, ``conv2``) and the ``up_sample``
Sequential of transposed convolutions.  ``style_dim`` is the width of the
style vector, the input of each AdaIN's dense layer (flax infers it; the
adaptation models pass the ReID net's pooled width).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch.models.layers import Conv2d, ConvTranspose2d, cast_linear, lecun_normal_
from vqvae2_tpu_torch.models.vqvae import Quantize, ResBlock, _conv_nhwc, _to_nchw, _to_nhwc


class AdaIN(nn.Module):
    """``(1 + gamma(s)) * IN(x) + beta(s)`` on NCHW, the instance norm without
    affine (population variance, eps 1e-5); ``gamma`` and ``beta`` are the two
    halves of one dense layer ``fc`` of ``s``."""

    def __init__(self, style_dim: int, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(style_dim, 2 * num_features)
        lecun_normal_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        h = cast_linear(s, self.fc.weight, self.fc.bias, self.dtype)[:, :, None, None]
        gamma, beta = torch.chunk(h, 2, dim=1)
        mean = torch.mean(x, dim=(2, 3), keepdim=True)
        var = torch.var(x, dim=(2, 3), keepdim=True, correction=0)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        return (1 + gamma) * xn + beta


class AdainResBlk(nn.Module):
    """AdaIN -> ReLU -> 3x3 -> AdaIN -> ReLU -> 1x1, plus the skip (NCHW)."""

    def __init__(self, style_dim: int, in_channel: int, channel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = AdaIN(style_dim, in_channel, dtype)
        self.conv1 = Conv2d(in_channel, channel, 3, padding=1, dtype=dtype)
        self.norm2 = AdaIN(style_dim, channel, dtype)
        self.conv2 = Conv2d(channel, in_channel, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x, s)))
        h = self.conv2(F.relu(self.norm2(h, s)))
        return x + h


def _down2(in_channel: int, c: int, dtype) -> list:
    return [Conv2d(in_channel, c // 2, 4, stride=2, padding=1, dtype=dtype), nn.ReLU(),
            Conv2d(c // 2, c, 3, padding=1, dtype=dtype)]


def _down4(in_channel: int, c: int, dtype) -> list:
    return [Conv2d(in_channel, c // 2, 4, stride=2, padding=1, dtype=dtype), nn.ReLU(),
            Conv2d(c // 2, c, 4, stride=2, padding=1, dtype=dtype), nn.ReLU(),
            Conv2d(c, c, 3, padding=1, dtype=dtype)]


class EncoderDeep(nn.Module):
    """Encoder of stride 2, 4, 6 (2x then 4x) or 8 (4x then 4x): convolutions,
    residual blocks, ReLU.  ``(B, H, W, C)`` in and out."""

    def __init__(self, in_channel: int, channel: int, n_res_block: int, n_res_channel: int,
                 stride: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channel
        stages = {8: (_down4, _down4), 6: (_down2, _down4), 4: (_down4,), 2: (_down2,)}
        if stride not in stages:
            raise ValueError(f"unsupported stride {stride}")
        blocks, width = [], in_channel
        for stage in stages[stride]:
            blocks += stage(width, c, dtype)
            width = c
        blocks += [ResBlock(c, n_res_channel, dtype) for _ in range(n_res_block)]
        blocks.append(nn.ReLU())
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.blocks, x)


class DecoderDeep(nn.Module):
    """3x3 ``conv1``, residual blocks (AdaIN ones driven by ``s`` when
    ``style_dim > 0``), ReLU, then the transposed convolutions of stride 2, 4,
    6 (4x then 2x) or 8.  ``(B, H, W, C)`` in and out."""

    def __init__(self, in_channel: int, out_channel: int, channel: int, style_dim: int,
                 n_res_block: int, n_res_channel: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channel
        self.style_dim = style_dim
        self.conv1 = Conv2d(in_channel, c, 3, padding=1, dtype=dtype)
        if style_dim > 0:
            blocks = [AdainResBlk(style_dim, c, n_res_channel, dtype) for _ in range(n_res_block)]
        else:
            blocks = [ResBlock(c, n_res_channel, dtype) for _ in range(n_res_block)]
        self.blocks = nn.ModuleList(blocks)

        def up4(width):
            return [ConvTranspose2d(width, c // 2, 4, stride=2, padding=1, dtype=dtype),
                    nn.ReLU(),
                    ConvTranspose2d(c // 2, out_channel, 4, stride=2, padding=1, dtype=dtype)]

        def up2(width):
            return [ConvTranspose2d(width, out_channel, 4, stride=2, padding=1, dtype=dtype)]

        stages = {8: (up4, up4), 6: (up4, up2), 4: (up4,), 2: (up2,)}
        if stride not in stages:
            raise ValueError(f"unsupported stride {stride}")
        ups, width = [], c
        for stage in stages[stride]:
            ups += stage(width)
            width = out_channel
        self.up_sample = nn.Sequential(*ups)

    def forward(self, x: torch.Tensor, s: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.style_dim > 0 and s is None:
            raise ValueError("the style decoder needs a style vector")
        h = self.conv1(_to_nchw(x))
        for blk in self.blocks:
            h = blk(h, s) if self.style_dim > 0 else blk(h)
        return _to_nhwc(self.up_sample(F.relu(h)))


class VQVAE_Deep(nn.Module):
    """Deep two-level VQ-VAE.  Defaults as the reference's: channel 256, 6
    residual blocks of 128 channels, ``embed_dim`` 256, 512 codes, style width
    2048.  The bottom encoder has stride 6 (8x spatially), the top one stride
    2 on top of it; the combined latent (``upsample_t || quant_b``) has
    ``2 * embed_dim`` channels.  Images need H and W divisible by 16."""

    def __init__(self, in_channel: int = 3, channel: int = 256, n_res_block: int = 6,
                 n_res_channel: int = 128, embed_dim: int = 256, n_embed: int = 512,
                 decay: float = 0.99, out_channel: int = 3, style_dim: int = 2048,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = dict(in_channel=in_channel, channel=channel, n_res_block=n_res_block,
                           n_res_channel=n_res_channel, embed_dim=embed_dim, n_embed=n_embed,
                           decay=decay, out_channel=out_channel, style_dim=style_dim)
        self.channel, self.embed_dim, self.dtype = channel, embed_dim, dtype
        dt = dict(dtype=dtype)
        res = (n_res_block, n_res_channel)
        self.enc_b = EncoderDeep(in_channel, channel, *res, stride=6, **dt)
        self.enc_t = EncoderDeep(channel, channel, *res, stride=2, **dt)
        self.quantize_conv_t = Conv2d(channel, embed_dim, 1, **dt)
        self.quantize_t = Quantize(embed_dim, n_embed, decay)
        self.dec_t = DecoderDeep(embed_dim, embed_dim, channel, -1, *res, stride=2, **dt)
        self.quantize_conv_b = Conv2d(embed_dim + channel, embed_dim, 1, **dt)
        self.quantize_b = Quantize(embed_dim, n_embed, decay)
        self.upsample_t = ConvTranspose2d(embed_dim, embed_dim, 4, stride=2, padding=1, **dt)
        self.dec = DecoderDeep(2 * embed_dim, out_channel, channel, style_dim, *res, stride=6,
                               **dt)

    @property
    def latent_dim(self) -> int:
        return 2 * self.embed_dim

    def forward(self, x: torch.Tensor, style: Optional[torch.Tensor] = None,
                train: bool = False):
        """Returns ``(dec, diff, quant)``; ``train=True`` also takes one EMA
        step of both codebooks."""
        enc_b, enc_t = self.encode(x)
        quant_t, quant_b, diff, _, _ = self.quantize(enc_b, enc_t, train=train)
        quant = torch.cat([self.upsample_top(quant_t), quant_b], dim=-1)
        return self.decode(quant, style), diff, quant

    def encode(self, x: torch.Tensor):
        """``(enc_b, enc_t)``."""
        h, w = x.shape[1:3]
        if h % 16 or w % 16:
            raise ValueError(f"VQVAE_Deep needs image H and W divisible by 16, got {(h, w)}")
        enc_b = self.enc_b(x)
        return enc_b, self.enc_t(enc_b)

    def quantize(self, enc_b: torch.Tensor, enc_t: torch.Tensor, train: bool = False):
        """``(quant_t, quant_b, diff, id_t, id_b)``; ``diff`` is ``diff_t +
        diff_b``."""
        quant_t, diff_t, id_t = self.quantize_t(_conv_nhwc(self.quantize_conv_t, enc_t),
                                                train=train)
        enc_b = torch.cat([self.dec_t(quant_t), enc_b], dim=-1)
        quant_b, diff_b, id_b = self.quantize_b(_conv_nhwc(self.quantize_conv_b, enc_b),
                                                train=train)
        return quant_t, quant_b, diff_t + diff_b, id_t, id_b

    def upsample_top(self, quant_t: torch.Tensor) -> torch.Tensor:
        return _conv_nhwc(self.upsample_t, quant_t)

    def decode(self, quant: torch.Tensor, style: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.dec(quant, style)

    def decode_code(self, code_t: torch.Tensor, code_b: torch.Tensor,
                    style: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reconstruct from integer codes: the combined latent is assembled
        before the style decoder."""
        quant_t = self.quantize_t.embed_code(code_t).to(self.dtype)
        quant_b = self.quantize_b.embed_code(code_b).to(self.dtype)
        return self.decode(torch.cat([self.upsample_top(quant_t), quant_b], dim=-1), style)
