"""Adaptation models (port of ``vqvae2_tpu/models/adaptive.py``): a ReID net
(the person / style branch), VQ-VAE adaptor(s), non-local content <- style
fusion and a feature discriminator.

* :class:`ModelAdaptive` — ``EmbedNet`` + ``VQVAE(with_ir_head=True)`` + a
  style encoder (two stride-2 encoders) + spectral-norm 1x1 convolutions
  around a non-local fusion and two spectral-norm residual blocks;
* :class:`ModelAdaptive_Deep` — ``EmbedNet(gm_pool="off")`` + ``VQVAE_Deep``
  with two non-local fusions against the ReID net's x3 / x4 features and a
  discriminator with ``2 * class_num`` outputs;
* :class:`ModelAdaptiveBi_Deep` — two ``VQVAE_Deep`` adaptors, the ReID net
  and that discriminator (no fusions: nothing calls the JAX module's).

The methods are the JAX modules' (``encode_person``, ``encode_content``,
``quantize_content``, ``fuse``, ``decode``, ...), with their ``train=``:
``encode_person`` runs the ReID net in the mode ``train`` asks for and gives
it back as it was; ``fuse`` moves the fusions' batch-norm statistics and the
spectral norms' ``u`` and ``sigma`` only with ``train``; a quantizer takes its
EMA step only with ``train``.

Only the parameters that flax creates exist here.  ``ModelAdaptive_Deep`` of
the JAX package declares two spectral-norm convolutions ``conv1`` and
``conv2`` that no method calls, and ``ModelAdaptiveBi_Deep`` two fusions, so
flax gives them no variables: the port has no such modules.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from vqvae2_tpu_torch.models.embed_net import EmbedNet
from vqvae2_tpu_torch.models.layers import Discriminator, NonLocal, ResidualBlock, SNConv
from vqvae2_tpu_torch.models.resnet import expansion, pool_dim
from vqvae2_tpu_torch.models.vqvae import VQVAE, Encoder
from vqvae2_tpu_torch.models.vqvae_deep import VQVAE_Deep


@contextlib.contextmanager
def mode(module: nn.Module, train: bool):
    """``module`` and its submodules in training (``train``) or eval mode for
    the block, then each back in the mode it had."""
    before = [(m, m.training) for m in module.modules()]
    module.train(train)
    try:
        yield module
    finally:
        for m, was in before:
            m.training = was


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module``'s parameters take no gradient from what the block computes
    (gradients still flow through the module to its inputs)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p in params:
            p.requires_grad_(True)


def _fuse_level(fusion: NonLocal, blocks: nn.ModuleList, c: torch.Tensor, s: torch.Tensor,
                train: bool) -> torch.Tensor:
    f = fusion(c, s, train=train)
    h = f
    for blk in blocks:
        h = blk(h, update_stats=train)
    return h + f


class ModelAdaptive(nn.Module):
    """The classic adaptor (reference ``ModelAdaptive``).  ``ir_head=False``
    leaves out the adaptor's IR decoder: the JAX module declares it, but flax
    creates its variables only where a call reaches it, which the gray->color
    trainer's never does."""

    def __init__(self, class_num: int = 395, arch: str = "resnet18", style_dim: int = 128,
                 dtype: torch.dtype = torch.float32, ir_head: bool = True):
        super().__init__()
        dt = dict(dtype=dtype)
        self.person_id = EmbedNet(class_num, arch=arch)
        self.fusion = NonLocal(style_dim, style_dim, reduc_ratio=1, **dt)
        self.adaptor = VQVAE(with_ir_head=ir_head, **dt)
        self.encoder_s = nn.ModuleList([Encoder(3, style_dim, 3, 32, stride=2, **dt),
                                        Encoder(style_dim, style_dim, 3, 32, stride=2, **dt)])
        self.conv1 = SNConv(2 * self.adaptor.config["embed_dim"], style_dim, **dt)
        self.conv2 = SNConv(style_dim, style_dim, **dt)
        self.resblocks = nn.ModuleList([ResidualBlock(style_dim, **dt) for _ in range(2)])

    def encode_person(self, rgb: torch.Tensor, train: bool = False):
        """``(feat, score, x4, act_map, x3)``."""
        with mode(self.person_id, train):
            return self.person_id(xRGB=rgb, modal=1, with_feature=True)

    def encode_style(self, rgb: torch.Tensor) -> torch.Tensor:
        return self.encoder_s[1](self.encoder_s[0](rgb))

    def encode_content(self, img: torch.Tensor, train: bool = False):
        """The combined latent (upsampled top || bottom) and ``diff``."""
        quant_t, quant_b, diff, _, _ = self.adaptor.encode(img, train=train)
        return self.adaptor._merge(quant_t, quant_b), diff

    def fuse(self, content: torch.Tensor, style: torch.Tensor, train: bool = False):
        """SNConv -> NonLocal(content, style) -> two SN residual blocks + skip
        -> SNConv."""
        c = self.conv1(content, update_stats=train)
        return self.conv2(_fuse_level(self.fusion, self.resblocks, c, style, train),
                          update_stats=train)

    def decode(self, content: torch.Tensor) -> torch.Tensor:
        return self.adaptor.dec(content)

    def forward(self, img: torch.Tensor, train: bool = False):
        """The plain VQ-VAE pass: ``(dec, diff)``."""
        return self.adaptor(img, train=train)


class ModelAdaptive_Deep(nn.Module):
    """The deep adaptor (reference ``ModelAdaptive_Deep``).  ``VQVAE_Deep``
    keeps its fixed widths; ``style_dim`` (the residual blocks' width) must
    equal its ``channel``, as in the JAX package."""

    def __init__(self, class_num: int = 395, arch: str = "resnet18", style_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(dtype=dtype)
        e = expansion(arch)
        self.person_id = EmbedNet(class_num, arch=arch, gm_pool="off")
        self.adaptor = VQVAE_Deep(style_dim=pool_dim(arch), **dt)
        c = self.adaptor.channel
        self.fusion1 = NonLocal(c, 256 * e, reduc_ratio=1, **dt)
        self.fusion2 = NonLocal(c, 512 * e, reduc_ratio=1, **dt)
        self.resblocks1 = nn.ModuleList([ResidualBlock(style_dim, **dt) for _ in range(2)])
        self.resblocks2 = nn.ModuleList([ResidualBlock(style_dim, **dt) for _ in range(2)])
        self.discriminator = Discriminator(pool_dim(arch), class_num * 2)

    def encode_person(self, rgb: torch.Tensor, train: bool = False):
        """``(feat, score, x4, act_map, x3)``."""
        with mode(self.person_id, train):
            return self.person_id(xRGB=rgb, modal=1, with_feature=True)

    def encode_content(self, img: torch.Tensor):
        return self.adaptor.encode(img)

    def quantize_content(self, enc_b: torch.Tensor, enc_t: torch.Tensor, train: bool = False):
        """The combined latent (upsampled top || bottom) and ``diff``."""
        quant_t, quant_b, diff, _, _ = self.adaptor.quantize(enc_b, enc_t, train=train)
        return torch.cat([self.adaptor.upsample_top(quant_t), quant_b], dim=-1), diff

    def fuse(self, cb: torch.Tensor, ct: torch.Tensor, sb: torch.Tensor, st: torch.Tensor,
             train: bool = False):
        """Inject the detached x3 / x4 person features into the bottom / top
        contents."""
        cb = _fuse_level(self.fusion1, self.resblocks1, cb, sb.detach(), train)
        ct = _fuse_level(self.fusion2, self.resblocks2, ct, st.detach(), train)
        return cb, ct

    def decode(self, content: torch.Tensor, style: Optional[torch.Tensor] = None):
        return self.adaptor.decode(content, style)

    def encode_and_decode(self, img: torch.Tensor, style: Optional[torch.Tensor] = None,
                          train: bool = False) -> torch.Tensor:
        enc_b, enc_t = self.encode_content(img)
        content, _ = self.quantize_content(enc_b, enc_t, train=train)
        return self.decode(content, style)

    def discriminate(self, feat: torch.Tensor) -> torch.Tensor:
        return self.discriminator(feat)

    def forward(self, img: torch.Tensor, style: Optional[torch.Tensor] = None,
                train: bool = False):
        return self.adaptor(img, style, train=train)


class ModelAdaptiveBi_Deep(nn.Module):
    """The bidirectional variant (reference ``ModelAdaptiveBi_Deep``): two
    independent adaptors (gray -> IR and IR -> gray), the ReID net and the
    discriminator.  The JAX module also declares two fusions, but no method
    of it and no trainer calls them, so flax creates no variables for them:
    the port has none."""

    def __init__(self, class_num: int = 395, arch: str = "resnet18", style_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(dtype=dtype)
        self.person_id = EmbedNet(class_num, arch=arch, gm_pool="off")
        self.adaptor1 = VQVAE_Deep(style_dim=pool_dim(arch), **dt)
        self.adaptor2 = VQVAE_Deep(style_dim=pool_dim(arch), **dt)
        self.discriminator = Discriminator(pool_dim(arch), class_num * 2)

    def encode_person(self, rgb: torch.Tensor, train: bool = False):
        with mode(self.person_id, train):
            return self.person_id(xRGB=rgb, modal=1, with_feature=True)

    def _quantize_content(self, enc_b, enc_t, adaptor: VQVAE_Deep, train: bool = False):
        quant_t, quant_b, diff, _, _ = adaptor.quantize(enc_b, enc_t, train=train)
        return torch.cat([adaptor.upsample_top(quant_t), quant_b], dim=-1), diff

    def encode_content_1(self, img):
        return self.adaptor1.encode(img)

    def encode_content_2(self, img):
        return self.adaptor2.encode(img)

    def quantize_content_1(self, enc_b, enc_t, train: bool = False):
        return self._quantize_content(enc_b, enc_t, self.adaptor1, train=train)

    def quantize_content_2(self, enc_b, enc_t, train: bool = False):
        return self._quantize_content(enc_b, enc_t, self.adaptor2, train=train)

    def decode_1(self, content, style=None):
        return self.adaptor1.decode(content, style)

    def decode_2(self, content, style=None):
        return self.adaptor2.decode(content, style)

    def discriminate(self, feat: torch.Tensor) -> torch.Tensor:
        return self.discriminator(feat)

    def forward(self, img: torch.Tensor, style: Optional[torch.Tensor] = None,
                train: bool = False):
        return (self.adaptor1(img, style, train=train), self.adaptor2(img, style, train=train))
