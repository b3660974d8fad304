"""Lovasz-Softmax loss (Berman 2018; port of ``vqvae2_tpu/part/lovasz.py``).

Validity is a weight, not a filter: ignored pixels get error -1, sort to the
tail and take no part in the Lovasz gradient's cumulative sums, so every shape
is static.  Classes are a batch dimension: one sort of the ``(C, N)`` errors
along the pixels sorts every class at once.  The 'present' rule (classes absent
from the labels contribute nothing) is a masked mean.

The sort is not stable, nor is the JAX package's: pixels of equal error may
come out in another order.  The loss does not depend on that order; its
gradient does, among the tied pixels only.
"""

from __future__ import annotations

from typing import Optional

import torch


def _lovasz_grad_sorted(fg_sorted: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to the sorted errors,
    along the last dim, with invalid entries masked out of the cumulative
    intersection and union."""
    fg = fg_sorted * valid_sorted
    gts = torch.sum(fg, dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(fg, dim=-1)
    union = gts + torch.cumsum((1.0 - fg_sorted) * valid_sorted, dim=-1)
    jaccard = 1.0 - intersection / torch.maximum(union, union.new_tensor(1e-12))
    jaccard = torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)
    return jaccard * valid_sorted


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor, ignore: int = 255,
                   class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-class Lovasz-Softmax over ``probas (B, H, W, C)`` (class
    probabilities) and ``labels (B, H, W)`` in ``[0, C)`` or ``ignore``;
    ``class_weights`` ``(C,)`` optional.

    The work is laid out class-major, ``(C, N)``, so that the sort and the
    cumulative sums run along the contiguous last dim: a cumulative sum down
    the rows of an ``(N, C)`` tensor with C = 7 is one sequential pass of
    N steps for each of seven threads on the card."""
    c = probas.shape[-1]
    p = probas.reshape(-1, c).t()                                      # (C, N)
    lab = labels.reshape(-1)
    valid = lab != ignore
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab))
    classes = torch.arange(c, device=p.device)
    fgf = ((lab_safe[None, :] == classes[:, None]) & valid[None, :]).to(p.dtype)
    errors = torch.abs(fgf - p)
    # ignored pixels to the sort's tail; valid errors lie in [0, 1]
    errors = torch.where(valid[None, :], errors, torch.full_like(errors, -1.0))
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True)
    fg_sorted = torch.gather(fgf, -1, order)
    valid_sorted = (errors_sorted >= 0.0).to(p.dtype)
    grad = _lovasz_grad_sorted(fg_sorted, valid_sorted)
    losses = torch.sum(torch.maximum(errors_sorted, errors_sorted.new_tensor(0.0)) * grad, dim=-1)
    present = torch.sum(fgf, dim=-1) > 0
    if class_weights is not None:
        losses = losses * class_weights
    denom = torch.clamp(torch.sum(present.to(p.dtype)), min=1.0)
    return torch.sum(torch.where(present, losses, torch.zeros_like(losses))) / denom


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor, ignore: int = 255) -> torch.Tensor:
    """Binary Lovasz hinge over the whole batch."""
    lg = logits.reshape(-1)
    lab = labels.reshape(-1)
    valid = lab != ignore
    labf = torch.where(valid, lab, torch.zeros_like(lab)).to(lg.dtype)
    signs = 2.0 * labf - 1.0
    errors = 1.0 - lg * signs
    # -inf sends ignored pixels to the tail; valid hinge errors are finite
    errors = torch.where(valid, errors, torch.full_like(errors, -float("inf")))
    errors_sorted, order = torch.sort(errors, descending=True)
    lab_sorted = labf[order]
    valid_sorted = torch.isfinite(errors_sorted).to(lg.dtype)
    grad = _lovasz_grad_sorted(lab_sorted, valid_sorted)
    hinge = torch.relu(torch.where(valid_sorted > 0, errors_sorted,
                                   torch.zeros_like(errors_sorted)))
    return torch.dot(hinge, grad)
