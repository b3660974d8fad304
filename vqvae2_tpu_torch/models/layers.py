"""Pooling and normalisation helpers of the ReID nets (port of the part of
``vqvae2_tpu/models/layers.py`` the ReID + parsing path uses): L2
``Normalize``, GeM pooling and global average pooling, on ``(B, H, W, C)``.
The rest of that file (spectral-norm convolutions, instance norm, the
cross-attention non-local block, MLPs, the discriminator) belongs to the
adaptation and GAN models, not ported yet."""

from __future__ import annotations

import torch


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
