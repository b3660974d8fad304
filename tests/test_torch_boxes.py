"""The port's SSD box machinery (``detection/boxes.py``) against the JAX
package's: default boxes and the host NMS (copied: bit-equal), the box
conversions and IoU, target matching with padded ground-truth rows and with
two ground truths whose best default box is the same one (JAX's scatter
writes in order on the CPU, so the last claim wins; the port computes that
winner), decoding, and the MultiBox loss with tied negatives.

Tolerances: box arithmetic and the loss rtol 1e-6 / atol 1e-6 (the same fp32
operations in the same order); class targets, matches and ranks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.detection import boxes as JB
from vqvae2_tpu_torch.detection import boxes as TB

TOL = dict(rtol=1e-6, atol=1e-6)


def random_boxes(g, n, lo=0.02, hi=0.5):
    xy = g.uniform(0, 1 - hi, size=(n, 2))
    wh = g.uniform(lo, hi, size=(n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.fixture(scope="module")
def dboxes():
    db = TB.default_boxes_ssd300()
    return db, TB.ltrb_from_cxcywh(torch.from_numpy(db))


def test_default_boxes_and_nms_are_the_jax_packages():
    db = TB.default_boxes_ssd300()
    assert db.shape == (8732, 4) and db.dtype == np.float32
    np.testing.assert_array_equal(db, JB.default_boxes_ssd300())
    g = np.random.default_rng(0)
    boxes, scores = random_boxes(g, 200), g.uniform(size=200).astype(np.float32)
    scores[10:20] = scores[5]                       # ties keep argsort's order
    for thr, cap in ((0.45, 200), (0.3, 7), (0.9, 200)):
        np.testing.assert_array_equal(TB.nms_numpy(boxes, scores, thr, cap),
                                      JB.nms_numpy(boxes, scores, thr, cap))


def test_conversions_and_iou():
    g = np.random.default_rng(1)
    a, b = random_boxes(g, 30), random_boxes(g, 17)
    b[3] = 0.0                                        # a degenerate (padded) row
    np.testing.assert_allclose(TB.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(JB.box_iou(jnp.asarray(a), jnp.asarray(b))), **TOL)
    for t, j in ((TB.ltrb_from_cxcywh, JB.ltrb_from_cxcywh),
                 (TB.cxcywh_from_ltrb, JB.cxcywh_from_ltrb)):
        np.testing.assert_allclose(t(torch.from_numpy(a)).numpy(), np.asarray(j(jnp.asarray(a))),
                                   **TOL)
    # batched IoU is the per-image IoU
    bb = np.stack([b, b[::-1]])
    got = TB.box_iou(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(JB.box_iou(jnp.asarray(a),
                                                                 jnp.asarray(bb[i]))), **TOL)


def jax_encode(gt, labels, db):
    db_j = jnp.asarray(db)
    return jax.vmap(lambda b, l: JB.encode_targets(b, l, JB.ltrb_from_cxcywh(db_j), db_j))(
        jnp.asarray(gt), jnp.asarray(labels))


def shared_best_box_batch(db_ltrb):
    """Image 0: ground truths 0 and 2 are the same box (their best default
    box is one), then padded rows.  Image 1: a padded row between valid
    ones, and ground truth 1 sitting on default box 0 (which every padded
    row's argmax also claims)."""
    gt = np.zeros((2, 6, 4), np.float32)
    labels = np.zeros((2, 6), np.int32)
    gt[0, 0] = gt[0, 2] = [0.30, 0.30, 0.50, 0.55]
    gt[0, 1] = [0.05, 0.60, 0.25, 0.95]
    labels[0, :3] = [3, 5, 7]
    gt[1, 0] = [0.55, 0.10, 0.90, 0.40]
    gt[1, 1] = db_ltrb[0]
    gt[1, 3] = [0.10, 0.10, 0.60, 0.70]
    labels[1, [0, 1, 3]] = [2, 4, 6]
    return gt, labels


def test_encode_targets_with_a_shared_best_box_and_padded_rows(dboxes):
    db, db_ltrb = dboxes
    gt, labels = shared_best_box_batch(db_ltrb.numpy())
    loc_j, cls_j = jax_encode(gt, labels, db)
    loc_t, cls_t = TB.encode_targets(torch.from_numpy(gt), torch.from_numpy(labels), db_ltrb,
                                     torch.from_numpy(db))
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_j), **TOL)
    assert cls_t.dtype == torch.int32
    # the shared best box took the last ground truth's label (7, not 3)
    best = int(np.argmax(np.asarray(JB.box_iou(db_ltrb.numpy(), gt[0, :1]))[:, 0]))
    assert int(cls_t[0, best]) == 7 == int(cls_j[0, best])
    # default box 0: claimed by ground truth 1 of image 1, then by the padded
    # rows after it, whose write (valid False) is the last
    assert int(cls_j[1, 0]) == int(cls_t[1, 0])


def test_last_writer_is_jaxs_scatter_order():
    index = np.asarray([[3, 5, 3, 0, 0]])
    values = np.asarray([1, 2, 3, 4, 5], np.float32)
    want = np.asarray(jnp.zeros(8).at[index[0]].set(values))
    writer = TB.last_writer(torch.from_numpy(index), 8)[0].numpy()
    got = np.where(writer >= 0, values[np.clip(writer, 0, None)], 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, [5, 0, 0, 3, 0, 2, 0, 0])


def test_random_targets_and_decode(dboxes):
    db, db_ltrb = dboxes
    g = np.random.default_rng(2)
    gt = np.stack([random_boxes(g, 8) for _ in range(3)])
    gt[:, 5:] = 0.0
    labels = g.integers(1, 14, size=(3, 8)).astype(np.int32)
    labels[:, 5:] = 0
    loc_j, cls_j = jax_encode(gt, labels, db)
    loc_t, cls_t = TB.encode_targets(torch.from_numpy(gt), torch.from_numpy(labels), db_ltrb,
                                     torch.from_numpy(db))
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    np.testing.assert_allclose(loc_t.numpy(), np.asarray(loc_j), **TOL)
    loc = g.normal(size=(3, 8732, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TB.decode_boxes(torch.from_numpy(loc), torch.from_numpy(db)).numpy(),
        np.asarray(JB.decode_boxes(jnp.asarray(loc), jnp.asarray(db))), **TOL)


@pytest.mark.parametrize("case", ["random", "tied negatives", "no positives"])
def test_multibox_loss(case):
    g = np.random.default_rng(3)
    b, d, c = 3, 64, 5
    loc = g.normal(size=(b, d, 4)).astype(np.float32)
    loc_t = g.normal(size=(b, d, 4)).astype(np.float32)
    logits = g.normal(size=(b, d, c)).astype(np.float32)
    cls_t = np.where(g.uniform(size=(b, d)) < 0.1, g.integers(1, c, size=(b, d)), 0)
    cls_t = cls_t.astype(np.int32)
    if case == "tied negatives":
        logits[:, 20:50] = logits[0, 20]           # 30 negatives a row with one CE
        cls_t[:, 20:50] = 0
        cls_t[:, :4] = [1, 2, 3, 4]                # 4 positives: 12 negatives of the tie taken
        cls_t[:, 4:20] = 0
        cls_t[:, 50:] = 0
    if case == "no positives":
        cls_t[1] = 0
    args = (loc, logits, loc_t, cls_t)
    want = float(JB.multibox_loss(*map(jnp.asarray, args)))
    got = float(TB.multibox_loss(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, **TOL)
    if case == "tied negatives":
        # the rank the mining takes: a stable sort on both sides, so the
        # tied negatives rank by index (the loss alone cannot tell: tied
        # negatives have the same CE)
        con = np.where(cls_t > 0, 0.0, -logits[..., 0]).astype(np.float32)
        want_rank = np.asarray(jnp.argsort(jnp.argsort(-jnp.asarray(con), axis=1), axis=1))
        order = torch.argsort(-torch.from_numpy(con), dim=1, stable=True)
        np.testing.assert_array_equal(torch.argsort(order, dim=1, stable=True).numpy(),
                                      want_rank)
