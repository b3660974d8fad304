"""SSD300-style detector (port of ``vqvae2_tpu/detection/ssd.py``): a ResNet
backbone to layer3, four extra down-sampling blocks, and per-level 3x3
loc/conf heads over the 8,732 default boxes.

``(B, 300, 300, 3)`` in; ``loc (B, 8732, 4)`` and ``conf (B, 8732,
num_classes)`` out.  Each level's head output ``(B, H, W, nb * 4)`` is
reshaped to ``(B, H * W * nb, 4)`` in that (row, column, box) order and the
levels are concatenated, as the JAX package does: the order ties a row to a
default box.  The convolutions take ``(B, H, W, C)`` and return it, so
nothing is permuted to NCHW before the reshape.

The extra blocks' strided 3x3 convolution pads as flax's ``"SAME"`` does:
the total pad split with the smaller half first, so 10 -> 5 pads (0, 1),
where a symmetric ``padding=1`` would move the output by one pixel.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch.models.layers import same_pads
from vqvae2_tpu_torch.models.resnet import (CONFIGS, BatchNorm, Conv2d, ResNetStem,
                                            _make_layer, expansion)

# boxes per feature level (SSD300: 4, 6, 6, 6, 4, 4)
DEFAULT_NUM_BOXES = (4, 6, 6, 6, 4, 4)


class ExtraBlock(nn.Module):
    """1x1 conv -> BN -> ReLU -> 3x3 conv (stride ``stride``; flax's "SAME",
    or no pad with ``pad_valid``) -> BN -> ReLU."""

    def __init__(self, in_features: int, mid: int, out: int, stride: int = 2,
                 pad_valid: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.pad_valid = stride, pad_valid
        self.conv1 = Conv2d(in_features, mid, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv2d(mid, out, 3, stride, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        if not self.pad_valid:
            (top, bottom), (left, right) = (same_pads(s, 3, self.stride) for s in h.shape[1:3])
            h = F.pad(h, (0, 0, left, right, top, bottom))
        return F.relu(self.bn2(self.conv2(h)))


class SSD300(nn.Module):
    """SSD over a ResNet backbone: the stem (ReLU after it), layer2 (38x38 at
    300 px) and layer3 (19x19), extra blocks to 10, 5, 3 and 1, and a loc and
    a conf head at each of the six levels."""

    def __init__(self, num_classes: int = 81, arch: str = "resnet18",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg, e = CONFIGS[arch], expansion(arch)
        self.num_classes = num_classes
        self.stem = ResNetStem(arch, dtype=dtype)
        self.layer2 = _make_layer(cfg["block"], 128, cfg["layers"][1], 2, 64 * e, dtype)
        self.layer3 = _make_layer(cfg["block"], 256, cfg["layers"][2], 2, 128 * e, dtype)
        self.extra0 = ExtraBlock(256 * e, 256, 512, dtype=dtype)
        self.extra1 = ExtraBlock(512, 256, 256, dtype=dtype)
        self.extra2 = ExtraBlock(256, 128, 256, stride=1, pad_valid=True, dtype=dtype)
        self.extra3 = ExtraBlock(256, 128, 256, stride=1, pad_valid=True, dtype=dtype)
        widths = (128 * e, 256 * e, 512, 256, 256, 256)
        self.loc = nn.ModuleList(Conv2d(c, nb * 4, 3, padding=1, dtype=dtype)
                                 for c, nb in zip(widths, DEFAULT_NUM_BOXES))
        self.conf = nn.ModuleList(Conv2d(c, nb * num_classes, 3, padding=1, dtype=dtype)
                                  for c, nb in zip(widths, DEFAULT_NUM_BOXES))

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.stem(x))
        for blk in self.layer2:
            h = blk(h)
        feats = [h]                                       # 38x38
        for blk in self.layer3:
            h = blk(h)
        feats.append(h)                                   # 19x19
        for extra in (self.extra0, self.extra1, self.extra2, self.extra3):
            h = extra(h)
            feats.append(h)                               # 10, 5, 3, 1
        return feats

    def forward(self, x: torch.Tensor):
        locs, confs = [], []
        for f, loc, conf in zip(self.features(x), self.loc, self.conf):
            b = f.shape[0]
            locs.append(loc(f).reshape(b, -1, 4))
            confs.append(conf(f).reshape(b, -1, self.num_classes))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)
