"""Dual-stream cross-modal ReID network (port of
``vqvae2_tpu/models/embed_net.py``): per-modality ResNet stems (thermal,
visible, z) over a shared trunk with layer4 at stride 1, or the trunk with
self non-local blocks (``no_local="on"``); GeM (``gm_pool="on"``) or average
pooling; a bias-free batch-norm neck and a bias-free classifier; the
feature-norm mask; and the optional 6-part head.

Every module takes and returns ``(B, H, W, C)``.  Training or eval mode is the
module's own (``model.train()`` / ``model.eval()``), where the JAX package
passes ``train=``.  As in the JAX package, only the modules a forward can
reach have parameters: ``base_resnet`` without ``no_local``, ``nl_trunk``
with it, and the neck and classifier only without ``part``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqvae2_tpu_torch.models.layers import avg_pool, compute_mask, gem_pool, l2_normalize
from vqvae2_tpu_torch.models.resnet import (BatchNorm, Dense, ResNetStem, ResNetTrunk,
                                            pool_dim)


class BNNeck(nn.Module):
    """flax ``BatchNorm`` with no bias (the reference freezes the shift at 0)."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class PartHead(nn.Module):
    """6-part local head: GeM (p = 10, ``+ 1e-12`` inside the mean) over six
    horizontal bins of x4, then per part a dense layer to 512, a batch norm, a
    ReLU and a classifier.  Returns ``(feats, logits, concatenated feats)``."""

    def __init__(self, in_features: int, class_num: int, n_parts: int = 6, p: float = 10.0):
        super().__init__()
        self.n_parts, self.p = n_parts, p
        for i in range(n_parts):
            setattr(self, f"local_conv{i}", Dense(in_features, 512))
            setattr(self, f"local_bn{i}", BatchNorm(512))
            setattr(self, f"fc{i}", Dense(512, class_num))

    def forward(self, x4: torch.Tensor):
        b, h, w, c = x4.shape
        if h % self.n_parts:
            raise ValueError(f"H={h} not divisible into {self.n_parts} parts")
        binned = x4.reshape(b, self.n_parts, h // self.n_parts, w, c)
        pooled = torch.pow(torch.mean(torch.pow(binned, self.p) + 1e-12, dim=(2, 3)),
                           1.0 / self.p)
        feats, logits = [], []
        for i in range(self.n_parts):
            f = getattr(self, f"local_conv{i}")(pooled[:, i])
            f = torch.relu(getattr(self, f"local_bn{i}")(f))
            feats.append(f)
            logits.append(getattr(self, f"fc{i}")(f))
        return feats, logits, torch.cat(feats, dim=-1)


class EmbedNet(nn.Module):
    """The reference ``embed_net``.

    ``modal`` 0 concatenates (visible, or z where ``xRGB`` is absent, then
    thermal) on the batch axis; 1, 2 and 3 run the visible, thermal or z stem.
    Returns, with ``with_feature``, ``(feat_pool, logits, x4, mask, x3)`` in
    either mode; otherwise in training mode ``(feat_pool, logits)`` and in eval
    mode ``(l2(feat), l2(feat_pool))``.  With ``part`` it returns the part
    head's ``(feats, logits, feat_all)`` in training mode and ``(l2(feat_all),
    l2(feat_all))`` in eval mode."""

    def __init__(self, class_num: int, arch: str = "resnet50", gm_pool: str = "on",
                 no_local: str = "off", part: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.class_num, self.arch, self.gm_pool = class_num, arch, gm_pool
        self.no_local, self.part = no_local, part
        self.thermal_module = ResNetStem(arch, dtype)
        self.visible_module = ResNetStem(arch, dtype)
        self.z_module = ResNetStem(arch, dtype)
        if no_local == "on":
            from vqvae2_tpu_torch.part.part_model import NLTrunk

            self.nl_trunk = NLTrunk(arch, dtype)
        else:
            self.base_resnet = ResNetTrunk(arch, last_stride_1=True, dtype=dtype)
        self.pool_dim = pool_dim(arch)
        if part:
            self.part_head = PartHead(self.pool_dim, class_num)
        else:
            self.bottleneck = BNNeck(self.pool_dim)
            self.classifier = Dense(self.pool_dim, class_num, bias=False)

    @property
    def feature_dim(self) -> int:
        return 6 * 512 if self.part else self.pool_dim

    def forward(self, xRGB: Optional[torch.Tensor] = None, xIR: Optional[torch.Tensor] = None,
                xZ: Optional[torch.Tensor] = None, modal: int = 0, with_feature: bool = False):
        if modal == 0:
            x1 = self.visible_module(xRGB) if xRGB is not None else self.z_module(xZ)
            x = torch.cat([x1, self.thermal_module(xIR)], dim=0)
        elif modal == 1:
            x = self.visible_module(xRGB)
        elif modal == 2:
            x = self.thermal_module(xIR)
        elif modal == 3:
            x = self.z_module(xZ)
        else:
            raise ValueError(f"modal {modal}")

        if self.no_local == "on":
            _, x3, x4 = self.nl_trunk(x)
        else:
            x3, x4 = self.base_resnet(x)

        if self.part:
            feats, logits, feat_all = self.part_head(x4)
            if self.training:
                return feats, logits, feat_all
            return l2_normalize(feat_all), l2_normalize(feat_all)

        feat_pool = gem_pool(x4) if self.gm_pool == "on" else avg_pool(x4)
        feat = self.bottleneck(feat_pool)
        if with_feature:
            return feat_pool, self.classifier(feat), x4, compute_mask(x4), x3
        if not self.training:
            return l2_normalize(feat), l2_normalize(feat_pool)
        return feat_pool, self.classifier(feat)
