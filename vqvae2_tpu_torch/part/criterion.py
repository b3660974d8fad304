"""Parsing criterion stack (port of ``vqvae2_tpu/part/criterion.py``): masked
cross-entropy with an ignore label, class-weighted edge cross-entropy,
:func:`generate_edge` (label boundaries in four directions, dilated), the
parsing-edge consistency term, KL distillation, the part-wise InfoNCE
:func:`contrastive_loss`, the supervised contrastive loss and
:func:`criterion_all` (CE + Lovasz on two parsing heads, weighted edge CE,
consistency).  Logits are ``(B, H, W, C)``, labels ``(B, H, W)``.

Masked minima are ``torch.amin`` and bounds ``torch.maximum``: their
gradients share ties evenly, as JAX's do.

Under a process group (``parallel``) the pixel losses are over the global
batch, the ranks' rows together: every count a loss is normalised by (the
valid pixels, the class weights, the edge pixels) is summed over the ranks,
detached, before the division, and the Lovasz term runs on the global pixels
(``lovasz.py``).  Each of these losses then returns this rank's share of the
global value: the ranks' values sum to it, and the sum of their gradients is
its gradient.  :func:`contrastive_loss` pairs rows: it is given the global
rows (``parallel.gather_batch``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.part.lovasz import lovasz_softmax

IGNORE = 255


def _global_count(t: torch.Tensor) -> torch.Tensor:
    """A count (or sum of weights) over every rank's pixels, detached."""
    return par.all_reduce(t.detach())


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore: int = IGNORE,
                         class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE with an ignore label and optional per-class weights: the weighted
    mean ``sum(w_i * ce_i) / sum(w_i)`` over valid pixels."""
    c = logits.shape[-1]
    lab = labels.reshape(-1).to(torch.int64)
    valid = lab != ignore
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab))
    logp = F.log_softmax(logits.reshape(-1, c), dim=-1)
    ce = -torch.gather(logp, 1, lab_safe[:, None])[:, 0]
    if class_weights is not None:
        w = class_weights[lab_safe] * valid
    else:
        w = valid.to(ce.dtype)
    return torch.sum(ce * w) / torch.clamp(_global_count(torch.sum(w)), min=1e-12)


def generate_edge(label: torch.Tensor, edge_width: int = 3) -> torch.Tensor:
    """Label-boundary map: a pixel is an edge if it differs from its down,
    right, down-right or down-left neighbour (both not ignored), then dilated
    by an ``edge_width`` box with padding 1.  ``(B, H, W)`` int -> float
    {0, 1}."""
    lab = label.to(torch.int32)

    def diff(a, b):
        return ((a != b) & (a != IGNORE) & (b != IGNORE)).to(torch.float32)

    def pad(x, hpad, wpad):
        return F.pad(x, (wpad[0], wpad[1], hpad[0], hpad[1]))

    edge = torch.maximum(
        torch.maximum(pad(diff(lab[:, 1:, :], lab[:, :-1, :]), (1, 0), (0, 0)),
                      pad(diff(lab[:, :, :-1], lab[:, :, 1:]), (0, 0), (0, 1))),
        torch.maximum(pad(diff(lab[:, :-1, :-1], lab[:, 1:, 1:]), (0, 1), (0, 1)),
                      pad(diff(lab[:, :-1, 1:], lab[:, 1:, :-1]), (0, 1), (1, 0))))
    k = torch.ones((1, 1, edge_width, edge_width), dtype=torch.float32, device=edge.device)
    e = F.conv2d(edge[:, None], k, padding=1)[:, 0]
    return (e != 0).to(torch.float32)


def consistency_loss(parsing_logits: torch.Tensor, edge_logits: torch.Tensor,
                     label: torch.Tensor, ignore: int = IGNORE) -> torch.Tensor:
    """Smooth-L1 between the edges of the predicted parsing and the predicted
    edge, over valid pixels where both are edges (no gradient: argmaxes)."""
    pred = torch.argmax(parsing_logits, dim=-1)
    pred = torch.where(label == ignore, torch.full_like(pred, ignore), pred)
    gen_edge = generate_edge(pred)
    edge_pred = torch.argmax(edge_logits, dim=-1).to(torch.float32)
    valid = label != ignore
    pos_union = (gen_edge == 1) & (edge_pred == 1) & valid
    diff = gen_edge - edge_pred
    sl1 = torch.where(torch.abs(diff) < 1.0, 0.5 * diff * diff, torch.abs(diff) - 0.5)
    denom = _global_count(torch.sum(pos_union))
    loss = torch.sum(sl1 * pos_union) / torch.clamp(denom, min=1).to(sl1.dtype)
    return torch.where(denom > 0, loss, torch.zeros_like(loss))


def kl_divergence_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                       label: torch.Tensor, T: float = 1.0, ignore: int = IGNORE) -> torch.Tensor:
    """Masked KL distillation."""
    c = student_logits.shape[-1]
    logp = F.log_softmax(student_logits.reshape(-1, c) / T, dim=-1)
    q = torch.softmax(teacher_logits.reshape(-1, c) / T, dim=-1)
    valid = (label.reshape(-1) != ignore).to(logp.dtype)
    kl = torch.sum(q * (torch.log(torch.clamp(q, min=1e-12)) - logp), dim=-1)
    return T * T * torch.sum(kl * valid) / torch.clamp(_global_count(torch.sum(valid)), min=1.0)


def _resize_logits(logits: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` on ``(B, H, W, C)``."""
    return F.interpolate(logits.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True).permute(0, 2, 3, 1)


def criterion_all(preds_parsing: Sequence[torch.Tensor], preds_edge: Sequence[torch.Tensor],
                  target_parsing: torch.Tensor, target_edge: torch.Tensor,
                  lambda_1: float = 1.0, lambda_2: float = 1.0, lambda_3: float = 0.1,
                  ignore: int = IGNORE, groups: int = 1,
                  rows: Optional[int] = None) -> torch.Tensor:
    """Sum over the parsing heads of ``lambda_1 / 2 * (Lovasz + CE)`` at full
    resolution, ``lambda_2`` times the class-balanced edge CE, and
    ``lambda_3`` times the consistency term.  ``groups`` and ``rows`` say
    how a rank's rows lie in the global batch (``lovasz_softmax``)."""
    h, w = target_parsing.shape[1:3]
    counts = torch.stack([torch.sum(target_edge == 1), torch.sum(target_edge == 0)])
    pos, neg = _global_count(counts).to(torch.float32)
    tot = torch.clamp(pos + neg, min=1.0)
    edge_weights = torch.stack([pos / tot, neg / tot])

    loss = 0.0
    scaled_parsing = [_resize_logits(pp, (h, w)) for pp in preds_parsing]
    scaled_edge = [_resize_logits(pe, (h, w)) for pe in preds_edge]
    for sp in scaled_parsing:
        loss = loss + 0.5 * lambda_1 * (
            lovasz_softmax(torch.softmax(sp, dim=-1), target_parsing, ignore=ignore,
                           groups=groups, rows=rows)
            + masked_cross_entropy(sp, target_parsing, ignore=ignore))
    for se in scaled_edge:
        loss = loss + lambda_2 * masked_cross_entropy(se, target_edge, ignore=ignore,
                                                      class_weights=edge_weights)
    for sp in scaled_parsing:
        r = consistency_loss(sp, scaled_edge[0], target_parsing, ignore=ignore)
        loss = loss + lambda_3 * torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return loss


def contrastive_loss(feats: torch.Tensor, t: float = 0.07) -> torch.Tensor:
    """Part-wise InfoNCE over ``feats (B, K, C)``: positives are the same part
    across the batch (the hardest, least similar one), negatives the other
    parts."""
    b, k, c = feats.shape
    f = feats / (torch.linalg.norm(feats, dim=2, keepdim=True) + 1e-12)
    scores = torch.einsum("aid,bjd->abij", f, f)
    scores = scores.permute(0, 2, 1, 3).reshape(b * k, b * k)        # (a i) (b j)
    eye_k = torch.eye(k, dtype=torch.bool, device=feats.device)
    pos_mask = eye_k.repeat(b, b) & ~torch.eye(b * k, dtype=torch.bool, device=feats.device)
    neg_mask = (~eye_k).repeat(b, b)
    inf = torch.full_like(scores, float("inf"))
    l_pos = torch.amin(torch.where(pos_mask, scores, inf), dim=1)
    neg_logits = torch.where(neg_mask, scores, -inf)
    logits = torch.cat([l_pos[:, None], neg_logits], dim=1) / t
    return torch.mean(-F.log_softmax(logits, dim=1)[:, 0])


def sup_con_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None, temperature: float = 0.7,
                 base_temperature: float = 0.7) -> torch.Tensor:
    """Supervised contrastive loss (Khosla et al., contrast mode 'all') over
    ``features (bsz, n_views, dim)``."""
    if features.ndim != 3:
        raise ValueError(f"features must be (bsz, n_views, dim), got {tuple(features.shape)}")
    bsz, n_views, dim = features.shape
    if labels is not None:
        mask = (labels[:, None] == labels[None, :]).to(torch.float32)
    elif mask is None:
        mask = torch.eye(bsz, dtype=torch.float32, device=features.device)
    contrast = features.permute(1, 0, 2).reshape(n_views * bsz, dim)
    n = n_views * bsz
    logits = contrast @ contrast.t() / temperature
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    logits_mask = 1.0 - torch.eye(n, device=features.device)
    mask_full = mask.repeat(n_views, n_views) * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True) + 1e-12)
    denom = torch.clamp(torch.sum(mask_full, dim=1), min=1e-12)
    mean_log_prob_pos = torch.sum(mask_full * log_prob, dim=1) / denom
    return torch.mean(-(temperature / base_temperature) * mean_log_prob_pos)
