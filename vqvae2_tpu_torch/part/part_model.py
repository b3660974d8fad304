"""ReID + human-part parsing hybrid (port of ``vqvae2_tpu/part/part_model.py``):
the PSP context encoder, edge branch and parsing decoder, all on the fused
in-place ABN; the trunk with interleaved self non-local blocks; and
``EmbedNet2`` with per-part descriptors pooled through the predicted part masks.

Every module takes and returns ``(B, H, W, C)``.  Training or eval mode is the
module's own (``model.train()`` / ``model.eval()``), where the JAX package
passes ``train=``.  The parsing head's dropout draws from the ``generator``
handed to ``forward`` (a ``torch.Generator`` on the input's device), which
training requires.

Three things are mirrored as the JAX package has them, not as a torch habit
would write them:

* every resize (``_resize``, and the PSP bins whose sides do not divide the
  grid) is ``jax.image.resize``'s linear resize, which anti-aliases when it
  shrinks: ``F.interpolate(mode="bilinear", antialias=True)``, not
  ``adaptive_avg_pool2d``;
* ``NonLocalSelf`` has one inter channel and the unnormalised ``f / N``
  attention, no softmax;
* the batch norms outside the ABNs are flax's (``models/resnet.py``).

``dtype`` is the convolutions' compute type, passed down as the JAX package
passes it: every convolution runs in it, each ``InPlaceABN`` stores its output
in its input's type (bf16 after a bf16 convolution) with fp32 channel math,
and the batch norms and dense heads, which have no ``dtype`` there, promote to
fp32.  Where a bf16 tensor meets an fp32 one (a concatenation, the part-mask
pooling) the result is fp32, as JAX promotes it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch.models.abn import InPlaceABN
from vqvae2_tpu_torch.models.layers import avg_pool, gem_pool, l2_normalize, promote
from vqvae2_tpu_torch.models.pixelsnail import dropout
from vqvae2_tpu_torch.models.resnet import (CONFIGS, BatchNorm, Conv2d, Dense, ResNetStem,
                                            _make_layer, expansion, pool_dim)

PART_DROPOUT = 0.1


def _resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (b, h, w, c), "bilinear")`` on ``(B, H, W, C)``,
    in ``x``'s type.  A bf16 map is resized in fp32 and rounded once: the
    antialiased resize takes no bf16 on the CPU, and JAX's rounds its weights
    and each axis's pass to bf16, which differs by a bf16 rounding or two."""
    y = F.interpolate(x.permute(0, 3, 1, 2).to(torch.float32), size=tuple(hw),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Block means where both sides divide the grid, else the linear resize
    (as the JAX package does; torch's uneven adaptive bins differ)."""
    b, h, w, c = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return x.reshape(b, oh, h // oh, ow, w // ow, c).mean(dim=(2, 4))
    return _resize(x, (oh, ow))


class NonLocalSelf(nn.Module):
    """Self non-local block with the reference's quirks: ``inter_channels = 1``
    and the unnormalised ``f / N`` attention."""

    def __init__(self, in_features: int, inter_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.inter = inter_channels
        self.g = Conv2d(in_features, inter_channels, 1, dtype=dtype)
        self.theta = Conv2d(in_features, inter_channels, 1, dtype=dtype)
        self.phi = Conv2d(in_features, inter_channels, 1, dtype=dtype)
        self.W_conv = Conv2d(inter_channels, in_features, 1, dtype=dtype)
        self.W_bn = BatchNorm(in_features, scale_init=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = self.g(x).reshape(b, h * w, self.inter)
        theta = self.theta(x).reshape(b, h * w, self.inter)
        phi = self.phi(x).reshape(b, h * w, self.inter)
        f = torch.einsum("bqi,bki->bqk", theta, phi)
        y = torch.einsum("bqk,bki->bqi", f / f.shape[-1], g).reshape(b, h, w, self.inter)
        return self.W_bn(self.W_conv(y)) + x


class ConvABN(nn.Module):
    """Convolution without bias + InPlaceABN (leaky ReLU 0.01); ``axis_name``
    as the JAX module threads it (``models/abn.py``: the ABN synchronises
    under a process group either way)."""

    def __init__(self, in_features: int, features: int, kernel: int = 1, dilation: int = 1,
                 dtype: torch.dtype = torch.float32, axis_name: Optional[str] = None):
        super().__init__()
        pad = (kernel // 2) * dilation if kernel > 1 else 0
        self.conv = Conv2d(in_features, features, kernel, padding=pad, dilation=dilation,
                           bias=False, dtype=dtype)
        self.abn = InPlaceABN(features, axis_name=axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.abn(self.conv(x))


class PSPModule(nn.Module):
    """Pyramid scene parsing context."""

    def __init__(self, in_features: int, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6), dtype: torch.dtype = torch.float32,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.sizes = tuple(sizes)
        self.stages = nn.ModuleList(ConvABN(in_features, out_features, dtype=dtype,
                                            axis_name=axis_name)
                                    for _ in self.sizes)
        self.bottleneck = ConvABN(in_features + len(self.sizes) * out_features, out_features, 3,
                                  dtype=dtype, axis_name=axis_name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        priors = [_resize(stage(_adaptive_avg_pool(x, (size, size))), (h, w))
                  for size, stage in zip(self.sizes, self.stages)]
        return self.bottleneck(torch.cat(priors + [x], dim=-1))


class ASPPModule(nn.Module):
    """Atrous spatial pyramid (kept for parity; ``PartModel`` uses PSP)."""

    def __init__(self, in_features: int, inner_features: int = 256, out_features: int = 512,
                 dilations: Sequence[int] = (12, 24, 36), dtype: torch.dtype = torch.float32,
                 axis_name: Optional[str] = None):
        super().__init__()
        ax = dict(dtype=dtype, axis_name=axis_name)
        self.conv1 = ConvABN(in_features, inner_features, **ax)
        self.conv2 = ConvABN(in_features, inner_features, **ax)
        self.n_dilated = len(dilations)
        for i, d in enumerate(dilations):     # conv3, conv4, ... as the JAX module names them
            setattr(self, f"conv{i + 3}",
                    ConvABN(in_features, inner_features, 3, dilation=d, **ax))
        self.bottleneck = ConvABN(inner_features * (2 + len(dilations)), out_features, **ax)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, w = x.shape[1:3]
        feats = [_resize(self.conv1(_adaptive_avg_pool(x, (1, 1))), (h, w)), self.conv2(x)]
        feats += [getattr(self, f"conv{i + 3}")(x) for i in range(self.n_dilated)]
        out = self.bottleneck(torch.cat(feats, dim=-1))
        return dropout(out, PART_DROPOUT, self.training, generator)


class EdgeModule(nn.Module):
    """Edge branch over (layer1, layer2, layer3) features; the 3x3 logit
    convolution ``conv4`` is shared across the three scales."""

    def __init__(self, in_features: Sequence[int], mid_fea: int = 256, out_fea: int = 2,
                 dtype: torch.dtype = torch.float32, axis_name: Optional[str] = None):
        super().__init__()
        c1, c2, c3 = in_features
        self.conv1 = ConvABN(c1, mid_fea, dtype=dtype, axis_name=axis_name)
        self.conv2 = ConvABN(c2, mid_fea, dtype=dtype, axis_name=axis_name)
        self.conv3 = ConvABN(c3, mid_fea, dtype=dtype, axis_name=axis_name)
        self.conv4 = Conv2d(mid_fea, out_fea, 3, padding=1, dtype=dtype)
        self.conv5 = Conv2d(out_fea * 3, out_fea, 1, dtype=dtype)

    def forward(self, x1, x2, x3):
        h, w = x1.shape[1:3]
        fea1, fea2, fea3 = self.conv1(x1), self.conv2(x2), self.conv3(x3)
        e1, e2, e3 = self.conv4(fea1), self.conv4(fea2), self.conv4(fea3)
        fea2, fea3 = _resize(fea2, (h, w)), _resize(fea3, (h, w))
        e2, e3 = _resize(e2, (h, w)), _resize(e3, (h, w))
        edge = self.conv5(torch.cat([e1, e2, e3], dim=-1))
        return edge, torch.cat([fea1, fea2, fea3], dim=-1)


class DecoderModule(nn.Module):
    """Parsing decoder: context features up to the layer1 grid, joined with
    48 channels of layer1."""

    def __init__(self, num_classes: int, in_features: Sequence[int],
                 dtype: torch.dtype = torch.float32, axis_name: Optional[str] = None):
        super().__init__()
        ct, cl = in_features
        ax = dict(dtype=dtype, axis_name=axis_name)
        self.conv1 = ConvABN(ct, 256, **ax)
        self.conv2 = ConvABN(cl, 48, **ax)
        self.conv3a = ConvABN(256 + 48, 256, **ax)
        self.conv3b = ConvABN(256, 256, **ax)
        self.conv4 = Conv2d(256, num_classes, 1, dtype=dtype)

    def forward(self, xt: torch.Tensor, xl: torch.Tensor):
        h, w = xl.shape[1:3]
        xt = _resize(self.conv1(xt), (h, w))
        x = torch.cat([xt, self.conv2(xl)], dim=-1)
        x = self.conv3b(self.conv3a(x))
        return self.conv4(x), x


class PartModel(nn.Module):
    """Parsing head: PSP context + decoder + edge + fusion.  ``in_features``
    are the widths of (x4, x1, x2, x3).  Returns ``([[parsing, fusion],
    [edge]], fused_fea)``."""

    def __init__(self, num_part: int, in_features: Sequence[int],
                 dtype: torch.dtype = torch.float32, axis_name: Optional[str] = None):
        super().__init__()
        c4, c1, c2, c3 = in_features
        ax = dict(dtype=dtype, axis_name=axis_name)
        self.context_encoding = PSPModule(c4, 512, **ax)
        self.decoder = DecoderModule(num_part, (512, c1), **ax)
        self.edge = EdgeModule((c1, c2, c3), **ax)
        self.fusion_abn = ConvABN(256 + 3 * 256, 256, **ax)
        self.fusion_out = Conv2d(256, num_part, 1, dtype=dtype)

    def forward(self, x4, x1, x2, x3, generator: Optional[torch.Generator] = None):
        ctx = self.context_encoding(x4)
        parsing, parsing_fea = self.decoder(ctx, x1)
        edge, edge_fea = self.edge(x1, x2, x3)
        x = torch.cat([parsing_fea, edge_fea], dim=-1)
        h = dropout(self.fusion_abn(x), PART_DROPOUT, self.training, generator)
        return [[parsing, self.fusion_out(h)], [edge]], x


def _nl_indices(n_blocks: int, n_nl: int):
    """Blocks after which a non-local block follows: the last ``n_nl``."""
    return [i for i in sorted(n_blocks - (j + 1) for j in range(n_nl)) if 0 <= i < n_blocks]


class NLTrunk(nn.Module):
    """layer2-4 with self non-local blocks after the last two blocks of layer2
    and the last three of layer3, layer4 at stride 1.  Returns
    ``(x2, x3, x4)``."""

    def __init__(self, arch: str = "resnet50", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg, e = CONFIGS[arch], expansion(arch)
        layers = cfg["layers"]
        self.layer2 = _make_layer(cfg["block"], 128, layers[1], 2, 64 * e, dtype)
        self.layer3 = _make_layer(cfg["block"], 256, layers[2], 2, 128 * e, dtype)
        self.layer4 = _make_layer(cfg["block"], 512, layers[3], 1, 256 * e, dtype)
        self.nl2_idx = _nl_indices(layers[1], 2)
        self.nl3_idx = _nl_indices(layers[2], 3)
        self.NL2 = nn.ModuleList(NonLocalSelf(128 * e, dtype=dtype) for _ in self.nl2_idx)
        self.NL3 = nn.ModuleList(NonLocalSelf(256 * e, dtype=dtype) for _ in self.nl3_idx)

    def forward(self, x: torch.Tensor):
        h = x
        for blocks, idx, nls in ((self.layer2, self.nl2_idx, self.NL2),
                                 (self.layer3, self.nl3_idx, self.NL3)):
            for i, blk in enumerate(blocks):
                h = blk(h)
                if i in idx:
                    h = nls[idx.index(i)](h)
            if blocks is self.layer2:
                x2 = h
        x3 = h
        for blk in self.layer4:
            h = blk(h)
        return x2, x3, h


class EmbedNet2(nn.Module):
    """ReID + parsing hybrid.

    Training mode, or ``with_feature=True``, returns the reference's 10-tuple
    ``(feats, score, part_preds, None, maskedFeatX3, maskedFeat, part_masks,
    partsScore, featsP, scoreP)``; eval mode returns ``(l2(x_pool),
    l2(feats))``.  ``modal`` 0 concatenates (visible or gray, thermal[, gray]);
    1, 2, 3 run one modality's stem.  ``dtype`` — the convolutions' compute
    type; the outputs come back in the types JAX's promotion gives them (the
    parsing maps and part masks in ``dtype``, the features and scores fp32)."""

    def __init__(self, class_num: int, arch: str = "resnet50", gm_pool: str = "on",
                 part_num: int = 7, dtype: torch.dtype = torch.float32,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.class_num, self.arch, self.gm_pool, self.part_num = class_num, arch, gm_pool, part_num
        e, width = expansion(arch), pool_dim(arch)
        self.thermal_module = ResNetStem(arch, dtype)
        self.visible_module = ResNetStem(arch, dtype)
        self.gray_module = ResNetStem(arch, dtype)
        self.trunk = NLTrunk(arch, dtype)
        self.bottleneck = BatchNorm(width, use_bias=False)
        self.part = PartModel(part_num, (width, 64 * e, 128 * e, 256 * e), dtype, axis_name)
        n = part_num - 1
        self.pd = nn.ModuleList(nn.Sequential(Dense(width, 512), Dense(512, 256))
                                for _ in range(n))
        self.clsP_bn = nn.ModuleList(BatchNorm(width) for _ in range(n))
        self.clsP_fc = nn.ModuleList(Dense(width, class_num) for _ in range(n))
        self.classifier = Dense(width + n * 256, class_num, bias=False)
        self.classifierP = Dense(n * 256, class_num, bias=False)

    def forward(self, xRGB=None, xIR=None, xZ=None, modal: int = 0, with_feature: bool = False,
                generator: Optional[torch.Generator] = None):
        if modal == 0:
            x1 = self.visible_module(xRGB) if xRGB is not None else self.gray_module(xZ)
            x = torch.cat([x1, self.thermal_module(xIR)], dim=0)
            if xZ is not None and xRGB is not None:
                x = torch.cat([x, self.gray_module(xZ)], dim=0)
        elif modal == 1:
            x = self.visible_module(xRGB)
        elif modal == 2:
            x = self.thermal_module(xIR)
        elif modal == 3:
            x = self.gray_module(xZ)
        else:
            raise ValueError(f"modal {modal}")

        x1f = x
        x2f, x3f, x4f = self.trunk(x)
        part_preds, _ = self.part(x4f, x1f, x2f, x3f, generator=generator)
        # part_masks: softmax(avg_pool4(fusion + fusion))
        fusion = part_preds[0][1]
        pooled = F.avg_pool2d((fusion + fusion).permute(0, 3, 1, 2), 4, 4).permute(0, 2, 3, 1)
        part_masks = torch.softmax(pooled, dim=-1)

        b, h, w, c = x4f.shape
        x_pool = gem_pool(x4f) if self.gm_pool == "on" else avg_pool(x4f)
        feat_g = self.bottleneck(x_pool)

        pm = _resize(part_masks[..., 1:], (h, w))            # background dropped
        masked_feat = torch.einsum("bhwr,bhwc->brc", promote(pm, x4f), x4f) / (h * w)
        h3, w3 = x3f.shape[1:3]
        pm3 = promote(_resize(pm, (h3, w3)), x3f)
        masked_feat_x3 = torch.einsum("bhwr,bhwc->brc", pm3, x3f) / (h3 * w3)

        parts_score, feats_p = [], []
        for i in range(self.part_num - 1):
            feats_p.append(self.pd[i](masked_feat[:, i]))
            parts_score.append(self.clsP_fc[i](self.clsP_bn[i](masked_feat[:, i])))
        feats_p = torch.cat(feats_p, dim=-1)
        score_p = self.classifierP(feats_p)
        feats = torch.cat([feat_g, feats_p], dim=-1)
        score = self.classifier(feats)

        if with_feature or self.training:
            return (feats, score, part_preds, None, masked_feat_x3, masked_feat, part_masks,
                    parts_score, feats_p, score_p)
        return l2_normalize(x_pool), l2_normalize(feats)
