"""ReID losses (port of ``vqvae2_tpu/losses.py``): the batch-hard triplets as
masked maxima and minima over the whole distance matrix.

Maxima and minima are ``torch.amax`` / ``torch.amin`` over rows and
``torch.maximum`` against a bound, whose gradients are shared evenly among tied
entries as JAX's are (``max(dim)`` and ``clamp`` give it all to one side).
"""

from __future__ import annotations

from typing import Tuple

import torch

_INF = 9999999.0


def pdist(emb1: torch.Tensor, emb2: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix."""
    sq1 = torch.sum(torch.square(emb1), dim=1, keepdim=True)
    sq2 = torch.sum(torch.square(emb2), dim=1, keepdim=True).t()
    d2 = sq1 + sq2 - 2.0 * emb1 @ emb2.t()
    return torch.sqrt(torch.maximum(d2, d2.new_tensor(1e-12)))


def _margin_ranking(dist_an: torch.Tensor, dist_ap: torch.Tensor, margin: float) -> torch.Tensor:
    """``MarginRankingLoss(y=1)``: ``mean(max(0, margin - (an - ap)))``."""
    gap = margin - (dist_an - dist_ap)
    return torch.mean(torch.maximum(gap, gap.new_tensor(0.0)))


def triplet_loss(inputs: torch.Tensor, targets: torch.Tensor,
                 margin: float = 0.3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-hard margin triplet.  Returns ``(loss, correct)``."""
    dist = pdist(inputs, inputs)
    same = targets[:, None] == targets[None, :]
    dist_ap = torch.amax(torch.where(same, dist, torch.full_like(dist, -_INF)), dim=1)
    dist_an = torch.amin(torch.where(same, torch.full_like(dist, _INF), dist), dim=1)
    loss = _margin_ranking(dist_an, dist_ap, margin)
    return loss, torch.sum(dist_an >= dist_ap)


def _softmax_weights(dist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    max_v = torch.amax(dist * mask, dim=1, keepdim=True)
    diff = dist - max_v
    z = torch.sum(torch.exp(diff) * mask, dim=1, keepdim=True) + 1e-6
    return torch.exp(diff) * mask / z


def triplet_loss_wrt(inputs: torch.Tensor, targets: torch.Tensor,
                     normalize_feature: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted regularized triplet with the soft margin.  Returns
    ``(loss, correct)``."""
    if normalize_feature:
        inputs = inputs / (torch.linalg.norm(inputs, dim=-1, keepdim=True) + 1e-12)
    dist = pdist(inputs, inputs)
    is_pos = (targets[:, None] == targets[None, :]).to(inputs.dtype)
    is_neg = 1.0 - is_pos
    dist_ap = dist * is_pos
    dist_an = dist * is_neg
    w_ap = _softmax_weights(dist_ap, is_pos)
    w_an = _softmax_weights(-dist_an, is_neg)
    furthest_pos = torch.mean(dist_ap * w_ap, dim=1)
    closest_neg = torch.mean(dist_an * w_an, dim=1)
    x = closest_neg - furthest_pos
    loss = torch.mean(torch.log1p(torch.exp(-x)))     # SoftMarginLoss(x, y=1)
    return loss, torch.sum(closest_neg >= furthest_pos)


def cross_triplet_loss(anchor: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                       label1: torch.Tensor, label2: torch.Tensor, label3: torch.Tensor,
                       margin: float = 0.3) -> torch.Tensor:
    """Batch-hard triplet across three (possibly different-modality) sets."""
    sim_p = (label1[:, None] == label2[None, :]).to(anchor.dtype)
    hard_p = torch.amax(pdist(anchor, pos) - _INF * (1.0 - sim_p), dim=1)
    sim_n = (label1[:, None] == label3[None, :]).to(anchor.dtype)
    hard_n = torch.amin(pdist(anchor, neg) + _INF * sim_n, dim=1)
    return _margin_ranking(hard_n, hard_p, margin)
