"""Lovasz-Softmax loss (Berman 2018; port of ``vqvae2_tpu/part/lovasz.py``).

Validity is a weight, not a filter: ignored pixels get error -1, sort to the
tail and take no part in the Lovasz gradient's cumulative sums, so every shape
is static.  Classes are a batch dimension: one sort of the ``(C, N)`` errors
along the pixels sorts every class at once.  The 'present' rule (classes absent
from the labels contribute nothing) is a masked mean.

The sort is stable, as the JAX package's ``lax.sort`` is: pixels of equal
error keep their order.  The loss does not depend on that order; its
gradient does, among the tied pixels only.

The Lovasz gradient ``g`` of the sorted errors depends on the labels and the
order only, so the loss is ``Σ max(error, 0) · g`` with ``g`` put back in the
pixels' own order and taken as a constant.  Under a process group
(``parallel``) the batch is the ranks' rows together: each rank gathers the
detached errors and the labels of every pixel in the global batch's order,
sorts them and computes ``g`` as one process would, and keeps its own pixels'
part of it.  Its value is then its share of the global loss (the ranks'
values sum to it) and its gradient the global loss's on its own rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from vqvae2_tpu_torch import parallel as par


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


def _foreground(lab: torch.Tensor, c: int, ignore: int, dtype) -> torch.Tensor:
    """``(C, N)`` foreground flags of labels ``(N,)``: class c and not ignored."""
    valid = lab != ignore
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab))
    classes = torch.arange(c, device=lab.device)
    return ((lab_safe[None, :] == classes[:, None]) & valid[None, :]).to(dtype)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor, ignore: int = 255,
                   class_weights: Optional[torch.Tensor] = None, groups: int = 1,
                   rows: Optional[int] = None) -> torch.Tensor:
    """Multi-class Lovasz-Softmax over ``probas (B, H, W, C)`` (class
    probabilities) and ``labels (B, H, W)`` in ``[0, C)`` or ``ignore``;
    ``class_weights`` ``(C,)`` optional.

    Under a process group ``B`` holds ``groups`` blocks of this rank's rows
    of a global batch of ``groups * rows`` rows (``rows`` is counted over
    the ranks when left out): see :func:`parallel.gather_batch` for the
    order.  The value is then this rank's share of the global loss.

    The work is laid out class-major, ``(C, N)``, so that the sort and the
    cumulative sums run along the contiguous last dim: a cumulative sum down
    the rows of an ``(N, C)`` tensor with C = 7 is one sequential pass of
    N steps for each of seven threads on the card."""
    c = probas.shape[-1]
    b = probas.shape[0]
    lab = labels.reshape(b, -1)
    valid = (lab != ignore).reshape(-1)
    fgf = _foreground(lab.reshape(-1), c, ignore, probas.dtype)          # (C, N)
    errors = torch.abs(fgf - probas.reshape(-1, c).t())
    # ignored pixels to the sort's tail; valid errors lie in [0, 1]
    errors = torch.where(valid[None, :], errors, torch.full_like(errors, -1.0))

    all_errors, all_lab = errors.detach(), lab
    if par.is_initialized():
        if rows is None:
            rows = int(par.all_reduce(torch.tensor([b // groups], device=probas.device))[0])
        # the global batch's pixels, in its order: rows of (pixels, C) and of labels
        all_errors = par.gather_batch(
            all_errors.t().reshape(b, -1, c), rows, groups).reshape(-1, c).t()
        small = torch.uint8 if 0 <= ignore < 256 and c <= 256 else lab.dtype
        all_lab = par.gather_batch(lab.to(small), rows, groups).to(lab.dtype)
    all_fg = _foreground(all_lab.reshape(-1), c, ignore, probas.dtype)
    errors_sorted, order = torch.sort(all_errors, dim=-1, descending=True, stable=True)
    fg_sorted = torch.gather(all_fg, -1, order)
    valid_sorted = (errors_sorted >= 0.0).to(probas.dtype)
    grad = torch.zeros_like(all_errors).scatter_(
        -1, order, _lovasz_grad_sorted(fg_sorted, valid_sorted))
    if par.is_initialized():
        grad = par.local_rows(grad.t().reshape(groups * rows, -1, c), rows,
                              groups).reshape(-1, c).t()
    losses = torch.sum(torch.maximum(errors, errors.new_tensor(0.0)) * grad, dim=-1)
    present = torch.sum(all_fg, dim=-1) > 0
    if class_weights is not None:
        losses = losses * class_weights
    denom = torch.clamp(torch.sum(present.to(probas.dtype)), min=1.0)
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
    errors_sorted, order = torch.sort(errors, descending=True, stable=True)
    lab_sorted = labf[order]
    valid_sorted = torch.isfinite(errors_sorted).to(lg.dtype)
    grad = _lovasz_grad_sorted(lab_sorted, valid_sorted)
    hinge = torch.relu(torch.where(valid_sorted > 0, errors_sorted,
                                   torch.zeros_like(errors_sorted)))
    return torch.dot(hinge, grad)
