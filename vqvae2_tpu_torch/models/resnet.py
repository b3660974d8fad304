"""ResNet backbone (18/34/50) of the ReID nets (port of
``vqvae2_tpu/models/resnet.py``).

Split into :class:`ResNetStem` (conv1 -> bn -> maxpool -> layer1, with no ReLU
after the batch norm: the reference's modality stems omit it) and
:class:`ResNetTrunk` (layer2-4, layer4 at stride 1 when ``last_stride_1``),
because the ReID nets build one stem per modality over a shared trunk.  The
stride of a bottleneck block is on its 3x3 convolution (torchvision's
ResNet-B).

Every module takes and returns ``(B, H, W, C)``.  Parameters carry
torchvision's names (``conv1.weight``, ``layer2.0.downsample.1.running_var``),
so :func:`import_torchvision_resnet` copies a torchvision ``state_dict`` key for
key, without torchvision.

:class:`BatchNorm` is flax's ``BatchNorm``, not torch's: the batch variance is
the biased ``E[x^2] - E[x]^2`` (clipped at 0) in the normalisation *and* in the
running variance, which moves with momentum 0.99; torch's ``batch_norm``
writes the unbiased variance.  The fused ABN (``models/abn.py``) keeps its own
unbiased update: the two are not interchangeable.

``dtype`` is the convolutions' compute type (``models/layers.py``).  The batch
norms and the dense layers have none, as in the JAX package: with fp32
parameters they promote a bf16 input and return fp32, so in the bf16 mode
every block's output is fp32 and only the convolutions run in bf16.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.models import layers

CONFIGS = {
    "resnet18": {"block": "basic", "layers": (2, 2, 2, 2), "width": 512},
    "resnet34": {"block": "basic", "layers": (3, 4, 6, 3), "width": 512},
    "resnet50": {"block": "bottleneck", "layers": (3, 4, 6, 3), "width": 2048},
}

class Conv2d(layers.Conv2d):
    """Convolution on ``(B, H, W, C)`` computing in ``dtype``, with flax's
    initialisers (LeCun normal, zero bias).  The permutes are views: a
    ``(B, H, W, C)`` tensor is NCHW in ``channels_last`` memory, which the
    convolution takes as it is."""

    def __init__(self, in_features: int, features: int, kernel_size=1, stride=1, padding=0,
                 dilation=1, bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, features, kernel_size, stride=stride, padding=padding,
                         dilation=dilation, bias=bias, dtype=dtype)
        with torch.no_grad():
            layers.lecun_normal_(self.weight)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Dense(nn.Linear):
    """``nn.Linear`` with flax's initialisers (LeCun normal, zero bias) and
    flax's promotion: a bf16 input is widened to the fp32 parameters."""

    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__(in_features, features, bias=bias)
        with torch.no_grad():
            layers.lecun_normal_(self.weight)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(layers.promote(x, self.weight))


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the last axis of ``(..., C)``.

    Training mode normalises with the batch's mean and biased variance
    ``max(E[x^2] - E[x]^2, 0)`` (the gradient flows through both) and moves
    the buffers ``running = momentum * running + (1 - momentum) * batch``; eval
    mode uses the buffers.  ``scale_init`` is the scale's initial value.  The
    moments are fp32 whatever ``x``'s type, so a bf16 ``x`` gives fp32.

    Under a process group (``parallel``) training mode is synchronised, as
    flax's is under GSPMD: the moments come from ``(n·E[x], n·E[x²], n)``
    summed over the ranks in one all-reduce, whose backward all-reduces the
    sums' gradients, so each rank's rows are normalised with the global batch's
    moments and the gradient is the global batch's.  Each rank takes the
    fp32 means of its rows' ``x`` and ``x²``, as flax reduces; the ranks'
    means weighted by their rows are added in fp64, as the in-place ABN's
    sums are: ``mean · n`` and the division by the total ``n`` are exact
    there, so one rank keeps its fp32 means bit for bit, with a group of
    one or without a group alike.  The running statistics move by the
    global moments, the same on every rank.  Eval mode makes no collective.
    (``torch.nn.SyncBatchNorm`` would write the unbiased variance.)"""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True, scale_init: float = 1.0):
        super().__init__()
        self.num_features, self.momentum, self.eps = num_features, momentum, eps
        self.weight = (nn.Parameter(torch.full((num_features,), float(scale_init)))
                       if use_scale else None)
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        """``train`` overrides the module's own mode (flax's
        ``use_running_average=not train``)."""
        if self.training if train is None else train:
            mean, var = self._moments(x)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = x - mean
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = y * mul
        if self.bias is not None:
            y = y + self.bias
        return y


    @staticmethod
    def _moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The batch's mean and biased variance over every rank's rows."""
        c, dims = x.shape[-1], tuple(range(x.ndim - 1))
        x32 = x.to(torch.float32)
        rows = x.numel() // c
        local = torch.cat([torch.mean(x32, dim=dims), torch.mean(torch.square(x32), dim=dims)]
                          if rows else [torch.sum(x32, dim=dims)] * 2)
        n = torch.full((1,), float(rows), dtype=torch.float64, device=x.device)
        total = par.all_reduce_sum(torch.cat([local.to(torch.float64) * n, n]))
        moments = (total[:-1] / total[-1].detach()).to(torch.float32)
        mean, mean2 = moments[:c], moments[c:]
        var = torch.maximum(mean2 - torch.square(mean), torch.zeros_like(mean))
        return mean, var


def max_pool(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding).permute(0, 2, 3, 1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = dict(bias=False, dtype=dtype)
        self.conv1 = Conv2d(in_features, features, 3, stride, padding=1, **dt)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, **dt)
        self.bn2 = BatchNorm(features)
        self.downsample = (nn.Sequential(Conv2d(in_features, features, 1, stride, **dt),
                                         BatchNorm(features)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        residual = self.downsample(x) if self.downsample is not None else x
        return F.relu(h + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        out = features * 4
        dt = dict(bias=False, dtype=dtype)
        self.conv1 = Conv2d(in_features, features, 1, **dt)
        self.bn1 = BatchNorm(features)
        # the stride sits on the 3x3 (ResNet-B); last-stride surgery zeroes it
        self.conv2 = Conv2d(features, features, 3, stride, padding=1, **dt)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv2d(features, out, 1, **dt)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(Conv2d(in_features, out, 1, stride, **dt),
                                         BatchNorm(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        residual = self.downsample(x) if self.downsample is not None else x
        return F.relu(h + residual)


def _make_layer(block_type: str, features: int, n_blocks: int, stride: int,
                in_features: int, dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    block = BasicBlock if block_type == "basic" else Bottleneck
    out_features = features * block.expansion
    need_ds = stride != 1 or in_features != out_features
    blocks = [block(in_features, features, stride, downsample=need_ds, dtype=dtype)]
    blocks += [block(out_features, features, dtype=dtype) for _ in range(1, n_blocks)]
    return nn.ModuleList(blocks)


def expansion(arch: str) -> int:
    return 1 if CONFIGS[arch]["block"] == "basic" else 4


class ResNetStem(nn.Module):
    """conv1 + bn1 + maxpool + layer1, with no ReLU after bn1."""

    def __init__(self, arch: str = "resnet50", dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = CONFIGS[arch]
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.layer1 = _make_layer(cfg["block"], 64, cfg["layers"][0], 1, 64, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.bn1(self.conv1(x))
        h = max_pool(h, 3, 2, 1)
        for blk in self.layer1:
            h = blk(h)
        return h


class ResNetTrunk(nn.Module):
    """layer2-4, layer4 at stride 1 when ``last_stride_1``.  Returns
    ``(x3, x4)``: the features of layer3 and of layer4."""

    def __init__(self, arch: str = "resnet50", last_stride_1: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg, e = CONFIGS[arch], expansion(arch)
        self.layer2 = _make_layer(cfg["block"], 128, cfg["layers"][1], 2, 64 * e, dtype)
        self.layer3 = _make_layer(cfg["block"], 256, cfg["layers"][2], 2, 128 * e, dtype)
        self.layer4 = _make_layer(cfg["block"], 512, cfg["layers"][3],
                                  1 if last_stride_1 else 2, 256 * e, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for blk in (*self.layer2, *self.layer3):
            h = blk(h)
        x3 = h
        for blk in self.layer4:
            h = blk(h)
        return x3, h


def pool_dim(arch: str) -> int:
    return CONFIGS[arch]["width"]


def _torchvision_tensors(sd) -> Dict[str, torch.Tensor]:
    """A torch ``state_dict`` (or a checkpoint wrapping one) as {torchvision
    key: tensor}: ``module.`` wrappers and any common prefix in front of the
    canonical names (``backbone.body.`` of a detection model) are stripped."""
    for key in ("state_dict", "model", "net"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    tensors = {}
    for k, v in sd.items():
        tensors[k[7:] if k.startswith("module.") else k] = torch.as_tensor(v).detach().cpu()
    if "conv1.weight" not in tensors:
        tails = [k for k in tensors if k.endswith("conv1.weight") and ".layer" not in k]
        if tails:
            prefix = tails[0][: -len("conv1.weight")]
            tensors = {k[len(prefix):]: v for k, v in tensors.items() if k.startswith(prefix)}
    return tensors


def import_torchvision_resnet(model: nn.Module,
                              state_dict: Union[str, Mapping[str, torch.Tensor]]) -> int:
    """Fill every ResNet stem and trunk of ``model`` from a torchvision
    ``state_dict`` (or the path of a file holding one), in place.

    Any sub-module with ``conv1``, ``bn1`` and ``layer1`` is a stem, filled
    from ``conv1``/``bn1``/``layer1``; each ``layer2``, ``layer3`` or
    ``layer4`` block list a sub-module has is filled from that layer, as the
    JAX package fills every ``layer{L}_{i}`` it finds (the detection models
    stop at ``layer3``).  Several stems (the ReID modality stems) all get
    the same weights, as the reference's deep copies of one pretrained base do.
    Keys the checkpoint lacks are left as they are; a shape that differs
    raises.  Returns the number of tensors copied."""
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
    sd = _torchvision_tensors(state_dict)
    copied = 0
    with torch.no_grad():
        for _, module in model.named_modules():
            groups: List[str] = []
            if all(hasattr(module, a) for a in ("conv1", "bn1", "layer1")):
                groups += ["conv1", "bn1", "layer1"]
            groups += [a for a in ("layer2", "layer3", "layer4")
                       if isinstance(getattr(module, a, None), nn.ModuleList)]
            for group in groups:
                for key, dst in getattr(module, group).state_dict(
                        prefix=f"{group}.", keep_vars=True).items():
                    if key not in sd:
                        continue
                    src = sd[key]
                    if tuple(src.shape) != tuple(dst.shape):
                        raise ValueError(
                            f"shape mismatch importing {key}: model {tuple(dst.shape)} vs "
                            f"checkpoint {tuple(src.shape)} — wrong arch?")
                    dst.copy_(src.to(dst.dtype))
                    copied += 1
    if copied == 0:
        raise ValueError("no ResNet stem/trunk pattern found in the model: nothing imported")
    return copied


def load_torchvision_weights(model: nn.Module, state_dict_path: str, arch: str = "") -> nn.Module:
    """Fill ``model``'s ResNet stems and trunks from a torchvision resnet
    ``.pt`` file (:func:`import_torchvision_resnet`) and return it.  ``arch``
    is taken and unused, as in the JAX package's signature."""
    import_torchvision_resnet(model, state_dict_path)
    return model
