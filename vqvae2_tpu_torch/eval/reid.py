"""ReID retrieval evaluation (port of ``vqvae2_tpu/eval/reid.py``).

The eval forward runs on the model's device under ``torch.no_grad()``; the
retrieval metrics stay in numpy on the host, the same code as the JAX
package's: the SYSU-MM01 protocol's identity-deduplicated CMC, mAP over the raw
ranking and mINP (``eval_sysu``), and the k-reciprocal re-ranking of
``rerank_dist``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np


def eval_sysu(distmat: np.ndarray, q_pids: np.ndarray, g_pids: np.ndarray,
              q_camids: Optional[np.ndarray] = None,
              g_camids: Optional[np.ndarray] = None,
              max_rank: int = 20) -> Tuple[np.ndarray, float, float]:
    """SYSU-MM01 metric.

    ``distmat``: (num_q, num_g), smaller = more similar.
    Returns ``(id_cmc[:max_rank], mAP, mINP)``.
    """
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    num_q, num_g = distmat.shape
    max_rank = min(max_rank, num_g)

    indices = np.argsort(distmat, axis=1)
    pred_label = g_pids[indices]
    matches = pred_label == q_pids[:, None]
    valid = matches.any(axis=1)                 # query id present in gallery
    num_valid_q = int(valid.sum())
    assert num_valid_q > 0, "no query identity appears in the gallery"

    # Identity-deduplicated CMC (reid_tools.py:193-198), closed form: after
    # dedup exactly one entry equals the query id, so the per-query curve is
    # a step at `number of DISTINCT gallery ids ranked strictly before the
    # first hit`.  First occurrences per (row, id): row-wise STABLE sort by
    # id keeps rank order within equal ids, so the head of each equal-id run
    # is the first occurrence — no per-query Python loop (the old loop was
    # O(Q·G·logG) host time at SYSU scale, minutes per validate call).
    order = np.argsort(pred_label, axis=1, kind="stable")
    sorted_ids = np.take_along_axis(pred_label, order, axis=1)
    head = np.concatenate(
        [np.ones((num_q, 1), dtype=bool),
         sorted_ids[:, 1:] != sorted_ids[:, :-1]], axis=1)
    first_occ = np.empty((num_q, num_g), dtype=bool)
    np.put_along_axis(first_occ, order, head, axis=1)

    first_hit = matches.argmax(axis=1)          # 0 for invalid rows (unused)
    before = np.arange(num_g)[None, :] < first_hit[:, None]
    distinct_before = (first_occ & before).sum(axis=1)
    distinct_before = np.where(valid, distinct_before, max_rank)  # all-miss row: zeros
    id_cmc = (np.arange(max_rank)[None, :] >= distinct_before[:, None])
    id_cmc = id_cmc.sum(axis=0).astype(np.float32) / num_valid_q

    cum = matches.cumsum(axis=1)
    prec = cum / (np.arange(num_g) + 1.0)[None, :]
    n_hits = matches.sum(axis=1)
    ap = (prec * matches).sum(axis=1)[valid] / n_hits[valid]

    pos_max = num_g - 1 - matches[:, ::-1].argmax(axis=1)
    inp = (cum[np.arange(num_q), pos_max] / (pos_max + 1.0))[valid]

    return id_cmc, float(ap.mean()), float(inp.mean())


def rerank_dist(prob_feat: np.ndarray, gal_feat: np.ndarray,
                k1: int = 20, k2: int = 6, lambda_value: float = 0.3
                ) -> np.ndarray:
    """k-reciprocal re-ranking (Zhong et al. CVPR'17; reference ``calc_dist``,
    reid_tools.py:238-305 with the same k1/k2/λ defaults).  float32 throughout
    (the reference's fp16 is a GPU-memory concession)."""
    q = prob_feat.shape[0]
    feat = np.concatenate([prob_feat, gal_feat], axis=0).astype(np.float32)
    n = feat.shape[0]

    sq = (feat ** 2).sum(1)
    original = sq[:, None] + sq[None, :] - 2.0 * feat @ feat.T
    np.clip(original, 0, None, out=original)
    original = (original / original.max(axis=0)).T
    rank = np.argsort(original, axis=1).astype(np.int32)

    def k_reciprocal_all(k: int):
        """Padded (n, k+1) reciprocal-neighbor table + validity mask, for
        every probe at once (the old per-call version re-ran the gather for
        every (i, candidate) pair — O(n·k1) redundant argsort-row reads)."""
        fwd = rank[:, : k + 1]                                # (n, k+1)
        back = rank[fwd, : k + 1]                             # (n, k+1, k+1)
        mask = (back == np.arange(n)[:, None, None]).any(-1)  # reciprocal?
        return fwd, mask

    recip_k1, recip_k1_mask = k_reciprocal_all(k1)
    half_k1 = int(np.around(k1 / 2))
    recip_h, recip_h_mask = k_reciprocal_all(half_k1)

    V = np.zeros_like(original)
    in_set = np.zeros(n, dtype=bool)  # reusable membership lookup
    for i in range(n):
        k_recip = recip_k1[i][recip_k1_mask[i]]
        in_set[k_recip] = True
        # candidate expansion, all candidates at once: a candidate's half-k
        # reciprocal set joins if >2/3 of it already lies in k_recip
        cand_sets = recip_h[k_recip]                          # (c, h+1)
        cand_valid = recip_h_mask[k_recip]
        inter = (in_set[cand_sets] & cand_valid).sum(1)
        take = inter > (2.0 / 3.0) * cand_valid.sum(1)
        expansion = np.unique(np.concatenate(
            [k_recip, cand_sets[take][cand_valid[take]]]))
        in_set[k_recip] = False
        w = np.exp(-original[i, expansion])
        V[i, expansion] = w / w.sum()

    if k2 != 1:
        # query-expansion smoothing without the (n, k2, n) gather blowup
        V = sum(V[rank[:, j]] for j in range(k2)) / k2

    original_q = original[:q]
    inv_index = [np.where(V[:, j] != 0)[0] for j in range(n)]
    jaccard = np.zeros_like(original_q)
    for i in range(q):
        temp_min = np.zeros(n, dtype=np.float32)
        nz = np.where(V[i] != 0)[0]
        for j in nz:
            rows = inv_index[j]
            temp_min[rows] += np.minimum(V[i, j], V[rows, j])
        jaccard[i] = 1.0 - temp_min / (2.0 - temp_min)

    final = jaccard * (1 - lambda_value) + original_q * lambda_value
    return final[:, q:]


def cosine_distmat(query_feat: np.ndarray, gall_feat: np.ndarray) -> np.ndarray:
    """-cosine similarity as a distance (reference test(), reid_tools.py:73-78:
    eval_sysu receives ``-q@gᵀ``)."""
    return -np.matmul(query_feat, gall_feat.T)


def extract_features(apply_fn: Callable, batches: Iterable, feat_dim: int,
                     modal: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched eval-mode feature extraction (reference ``ext_feat``,
    reid_tools.py:43-64): uses the L2-normalized attention feature (the
    second output of the eval forward)."""
    feats, labels, cams = [], [], []
    for imgs, lab, cam in batches:
        _, feat_att = apply_fn(imgs, modal)
        feats.append(np.asarray(feat_att)[:, :feat_dim])
        labels.append(np.asarray(lab))
        cams.append(np.asarray(cam))
    return (np.concatenate(feats), np.concatenate(labels),
            np.concatenate(cams))


def test_retrieval(query_feat, q_l, q_cam, gall_feat, g_l, g_cam,
                   rerank: bool = False):
    """Reference ``test`` (reid_tools.py:67-80): cosine retrieval (or
    re-ranked L2) → SYSU metric."""
    if rerank:
        distmat = rerank_dist(query_feat, gall_feat)
    else:
        distmat = cosine_distmat(query_feat, gall_feat)
    return eval_sysu(distmat, q_l, g_l, q_cam, g_cam)


def validate(model, data_path: str, mode: str = "all", test_batch: int = 50,
             img_size=(144, 288), trials: int = 1, seed: int = 0, device=None) -> float:
    """End-to-end SYSU validation: build query and gallery per protocol,
    extract the second output of the eval forward (the L2-normalised
    features) in batches of ``test_batch`` on ``device`` (the model's own by
    default), run cosine retrieval and average over ``trials`` gallery draws.
    Returns mAP and prints the CMC line.  The model is put in eval mode for
    the call and given back in the mode it had."""
    import torch

    from vqvae2_tpu_torch.data.sysu import TestData, process_sysu

    test_mode = {"Vis": (1, 1), "Ir": (2, 2)}.get(mode, (1, 2))
    rng = np.random.default_rng(seed)
    dev = torch.device(device) if device is not None else next(model.parameters()).device
    was_training = model.training
    model.eval()

    @torch.no_grad()
    def forward(imgs, modal):
        x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
        out = model(xRGB=x, modal=1) if modal == 1 else model(xIR=x, modal=2)
        return out[1].to(torch.float32).cpu().numpy()

    def extract(files, labels, cams, modal):
        td = TestData(files, labels, cams, img_size=img_size)
        feats = [forward(imgs, modal) for imgs, _, _ in td.batches(test_batch)]
        return np.concatenate(feats), td.test_label, td.test_cam - 1

    try:
        qf, ql, qc = extract(*process_sysu(data_path, data="query", mode=mode, rng=rng),
                             test_mode[1])
        cmc_sum, map_sum, minp_sum = None, 0.0, 0.0
        for _ in range(trials):
            gf, gl, gc = extract(*process_sysu(data_path, data="gallery", mode=mode,
                                               single_shot=True, rng=rng), test_mode[0])
            cmc, mAP, mINP = test_retrieval(qf, ql, qc, gf, gl, gc)
            cmc_sum = cmc if cmc_sum is None else cmc_sum + cmc
            map_sum += mAP
            minp_sum += mINP
    finally:
        model.train(was_training)
    cmc = cmc_sum / trials
    mAP, mINP = map_sum / trials, minp_sum / trials
    r = lambda k: cmc[min(k, len(cmc) - 1)]  # small galleries: clamp rank
    print(f"FC:   Rank-1: {r(0):.2%} | Rank-5: {r(4):.2%} | "
          f"Rank-10: {r(9):.2%}| Rank-20: {r(19):.2%}| "
          f"mAP: {mAP:.2%}| mINP: {mINP:.2%}", flush=True)
    return mAP
