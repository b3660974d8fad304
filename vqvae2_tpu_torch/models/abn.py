"""ABN modules (port of ``vqvae2_tpu/models/abn.py``): ``InPlaceABN``, the
fused op of ``ops/inplace_abn.py`` behind a module, and ``ABN``, plain batch
norm + activation.  Inputs are ``(..., C)`` with channels last.

Running statistics are buffers with torch's semantics, as in the JAX package:
``running = (1 - m) * running + m * batch`` with ``m = 0.1``, the variance
corrected to unbiased by ``count / (count - 1)``.  At ``count == 1`` (one row a
channel) that raises ``ZeroDivisionError``, as the JAX package does.

Under a process group (``parallel``) the in-place ABN is synchronised: moments,
``count`` and the backward sums are the global batch's, as the JAX package's
are under GSPMD (``axis_name=None``) and under ``shard_map`` with
``axis_name="data"``.  The port has that one data axis, so ``InPlaceABNSync``
is ``InPlaceABN(axis_name="data")`` and behaves as ``InPlaceABN`` does; both
names stay so that modules read as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqvae2_tpu_torch.models.resnet import BatchNorm
from vqvae2_tpu_torch.parallel import DATA_AXIS
from vqvae2_tpu_torch.ops.inplace_abn import (ACT_ELU, ACT_LEAKY_RELU, ACT_NONE,
                                              batch_statistics, inplace_abn)


class InPlaceABN(nn.Module):
    """Fused activated batch norm: in training mode it normalises with the
    batch's moments and advances the running statistics, in eval mode it uses
    them.  A bf16 ``x`` is taken as it is (the output of a bf16 convolution):
    moments, channel math and running statistics are fp32, the output is
    stored in bf16."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, activation: str = ACT_LEAKY_RELU, slope: float = 0.01,
                 axis_name: Optional[str] = None):
        super().__init__()
        if axis_name not in (None, DATA_AXIS):
            raise ValueError(f"the port has one axis, {DATA_AXIS!r}; got axis_name={axis_name!r}")
        self.num_features, self.eps, self.momentum = num_features, eps, momentum
        self.axis_name = axis_name
        self.activation, self.slope = activation, slope
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.num_features
        if x.shape[-1] != c:
            raise ValueError(f"expected {c} channels, got {tuple(x.shape)}")
        count = None
        if self.training:
            mean, var, count = batch_statistics(x)
            with torch.no_grad():
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * var * (count / (count - 1)))
        else:
            mean, var = self.running_mean, self.running_var
        return inplace_abn(x, self.weight, self.bias, mean, var, self.eps, self.activation,
                           self.slope, self.training, count)


def InPlaceABNSync(num_features: int, axis_name: str = DATA_AXIS, **kw) -> InPlaceABN:
    """Cross-rank-synced ABN (reference ``InPlaceABNSync``): moments and
    gradient sums over the ranks of the process group."""
    return InPlaceABN(num_features, axis_name=axis_name, **kw)


class ABN(nn.Module):
    """Plain batch norm + activation (flax ``BatchNorm`` semantics: biased
    batch variance ``E[x^2] - E[x]^2`` clipped at 0, the gradient through the
    moments by autograd), kept as the ground truth the fused op is held to."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, activation: str = ACT_LEAKY_RELU, slope: float = 0.01):
        super().__init__()
        self.bn = BatchNorm(num_features, momentum=1 - momentum, eps=eps, use_scale=affine,
                            use_bias=affine)
        self.activation, self.slope = activation, slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(x)
        if self.activation == ACT_LEAKY_RELU:
            return F.leaky_relu(x, self.slope)
        if self.activation == ACT_ELU:
            return F.elu(x)
        if self.activation == ACT_NONE:
            return x
        if self.activation == "relu":
            return F.relu(x)
        raise ValueError(self.activation)
