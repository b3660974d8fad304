"""The port's detection data, evaluation and drawing
(``detection/{data,coco_eval,visualize}.py``, numpy and PIL only) against
the JAX package's: the synthetic COCO set (the same files), every dataset
item (image, boxes, labels, rasterised masks) and the batches' order bit
for bit; box and mask AP on random predictions exactly; the drawn images
bit for bit."""

import json
import os

import numpy as np
import pytest

from vqvae2_tpu.detection import coco_eval as je
from vqvae2_tpu.detection import data as jd
from vqvae2_tpu.detection import visualize as jv
from vqvae2_tpu_torch.detection import coco_eval as te
from vqvae2_tpu_torch.detection import data as td
from vqvae2_tpu_torch.detection import visualize as tv


@pytest.mark.parametrize("with_masks", [False, True], ids=["boxes", "masks"])
def test_synthetic_set_and_items_are_bit_equal(tmp_path, with_masks):
    size = 96
    a = td.make_synthetic_coco(str(tmp_path / "port"), n=6, size=size, with_masks=with_masks)
    b = jd.make_synthetic_coco(str(tmp_path / "jax"), n=6, size=size, with_masks=with_masks)
    with open(a[1]) as f, open(b[1]) as g:
        assert json.load(f) == json.load(g)
    for name in sorted(os.listdir(b[0])):
        with open(os.path.join(a[0], name), "rb") as f, open(os.path.join(b[0], name), "rb") as g:
            assert f.read() == g.read(), name
    kw = dict(size=64, max_boxes=5, with_masks=with_masks)
    ours, theirs = td.CocoDetectionDataset(*a, **kw), jd.CocoDetectionDataset(*b, **kw)
    assert (len(ours), ours.num_classes, ours.class_names) == (
        len(theirs), theirs.num_classes, theirs.class_names)
    for i in range(len(ours)):
        for x, y in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for args in (dict(seed=3), dict(shuffle=False, drop_last=False)):
        for x, y in zip(ours.batches(4, with_masks=with_masks, **args),
                        theirs.batches(4, with_masks=with_masks, **args)):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def random_detections(g, n_img=5, size=None):
    preds, gts = [], []
    for img in range(n_img):
        n_gt = int(g.integers(0, 4))
        gt = g.uniform(0, 0.5, (n_gt, 2))
        gt = np.concatenate([gt, gt + g.uniform(0.1, 0.5, (n_gt, 2))], 1)
        labels = g.integers(1, 4, n_gt)
        n = int(g.integers(0, 8))
        det = np.concatenate([gt[:1].repeat(n // 2, 0) + g.normal(0, 0.03, (n // 2, 4)),
                              g.uniform(0, 1, (n - n // 2, 4))]) if n_gt else g.uniform(0, 1, (n, 4))
        det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 0.01)
        dl = np.concatenate([labels[:1].repeat(n // 2), g.integers(1, 4, n - n // 2)]) \
            if n_gt else g.integers(1, 4, n)
        if size:
            def raster(boxes):
                out = np.zeros((len(boxes), size, size), bool)
                for k, (x0, y0, x1, y1) in enumerate((np.clip(boxes, 0, 1) * size).astype(int)):
                    out[k, y0:y1, x0:x1] = True
                return out
            preds.append((img, raster(det), g.uniform(size=n), dl))
            gts.append((img, raster(gt), labels))
        else:
            preds.append((img, det, g.uniform(size=n), dl))
            gts.append((img, gt, labels))
    return preds, gts


def test_box_and_mask_ap_are_the_jax_packages():
    g = np.random.default_rng(0)
    preds, gts = random_detections(g)
    want = je.evaluate_detections(preds, gts)
    assert te.evaluate_detections(preds, gts) == want
    assert want["AP50"] > 0
    preds, gts = random_detections(np.random.default_rng(1), size=32)
    assert te.evaluate_segmentations(preds, gts) == je.evaluate_segmentations(preds, gts)


def test_drawing_is_the_jax_packages(tmp_path):
    g = np.random.default_rng(2)
    img = g.uniform(-1, 1, (48, 64, 3)).astype(np.float32)
    boxes = np.asarray([[0.1, 0.1, 0.5, 0.6], [10, 5, 40, 30]], np.float32)
    labels, scores = np.asarray([1, 3]), np.asarray([0.9, 0.7])
    masks = g.uniform(size=(2, 48, 64))
    for b in (boxes[:1], boxes[1:]):
        np.testing.assert_array_equal(
            tv.draw_detections(img, b, labels[:1], scores[:1], masks[:1],
                               class_names={1: "shirt"}),
            jv.draw_detections(img, b, labels[:1], scores[:1], masks[:1],
                               class_names={1: "shirt"}))
    for mod, name in ((tv, "port.png"), (jv, "jax.png")):
        mod.save_detections(str(tmp_path / name), img, boxes[:1], labels[:1], scores[:1],
                            gt_boxes=boxes[:1], gt_labels=labels[:1])
    with open(tmp_path / "port.png", "rb") as f, open(tmp_path / "jax.png", "rb") as h:
        assert f.read() == h.read()
