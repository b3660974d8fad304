"""The port's Mask R-CNN (``detection/mask_rcnn.py``) against the JAX
package's: anchors (bit-equal); ``roi_align``'s forward and its gradient in
the feature map against ``jax.grad``, boxes at the border and degenerate
ones included; the FPN at a size that is no multiple of 16 (c2/c3/c4 at
25/13/7, where torch's ``"nearest"`` would pick other rows than
``jax.image.resize``); the whole model at 64 px with ``--anchor_sizes
8,16,32`` in train and eval mode with its RoI heads; the targets with
shared best anchors and padded rows; ``decode_proposals`` with tied scores
(``jax.lax.top_k`` puts the lower index first); ``crop_gt_masks`` from the
uint8 masks; the loss and its five terms; and ``import_torchvision_resnet``
filling the stem, ``layer2`` and ``layer3`` as the JAX import does.

Weights: seeded numpy values for the union of the JAX trainer's two
``init`` trees, carried across by ``maskrcnn_from_jax``.  Tolerances:
activations and the loss rtol 1e-4 / atol 1e-5, the whole model's outputs
(of size up to 3, through a train-mode ResNet at batch 2) rtol 1e-4 / atol
5e-5 (measured 1.2e-5); ``roi_align`` and the
mask crops rtol 1e-5 / atol 1e-5 (the same fp32 operations, but XLA may
fuse the grid's multiply-adds: a sample point is (size - 1) times a box
coordinate, and one ulp of a point near 63 is 3.8e-6 of its weights;
measured 3.8e-6), box deltas rtol 1e-6 / atol 1e-6; the gradient of
``roi_align`` rtol 1e-5 / atol 1e-5 (sums of up to 4 samples a point);
running statistics rtol 1e-5 / atol 1e-7; targets, labels, matches and the
proposals' indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.detection import mask_rcnn as JM
from vqvae2_tpu.models import resnet as jr
from vqvae2_tpu_torch.detection import mask_rcnn as TM
from vqvae2_tpu_torch.models import resnet as tr
from vqvae2_tpu_torch.utils.jax_import import maskrcnn_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=5e-5)
EXACT_TOL = dict(rtol=1e-6, atol=1e-6)
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
SIZE, CLASSES, K, G = 64, 4, 8, 5
ANCHOR_SIZES = (8, 16, 32)


def seeded(shapes, seed):
    g = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", "")
        if leaf == "var":
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def maskrcnn_variables(jmod, seed=0):
    """The JAX trainer's two ``init`` trees, merged as it merges them."""
    v = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    r = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(1),
                                         jnp.zeros((1, SIZE // 4, SIZE // 4, 128)),
                                         jnp.zeros((1, K, 4)), method=jmod.roi_outputs))
    return seeded({"params": {**r["params"], **v["params"]},
                   "batch_stats": v["batch_stats"]}, seed)


def random_boxes(g, shape, lo=0.05, hi=0.6):
    xy = g.uniform(0, 1 - hi, size=(*shape, 2))
    wh = g.uniform(lo, hi, size=(*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_anchors_are_the_jax_packages():
    for size, sizes in ((256, (32, 64, 128)), (SIZE, ANCHOR_SIZES), (100, (8, 16, 32))):
        np.testing.assert_array_equal(TM.generate_anchors(size, sizes=sizes),
                                      JM.generate_anchors(size, sizes=sizes))


def test_roi_align_forward_and_gradient():
    g = np.random.default_rng(0)
    feat = g.normal(size=(2, 11, 13, 6)).astype(np.float32)
    boxes = random_boxes(g, (2, 7))
    boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]                 # the whole map: the clip at size - 2
    boxes[0, 1] = [0.3, 0.4, 0.3, 0.4]                 # degenerate
    boxes[1, 2] = [0.9, 0.05, 1.0, 0.2]                # at the border
    cot = g.normal(size=(2, 7, 5, 5, 6)).astype(np.float32)

    def jloss(f):
        out = jax.vmap(lambda a, b: JM.roi_align(a, b, 5))(f, jnp.asarray(boxes))
        return jnp.sum(out * cot), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(feat))
    f = torch.from_numpy(feat).requires_grad_()
    got = TM.roi_align(f, torch.from_numpy(boxes), 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SAMPLE_TOL)
    torch.sum(got * torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-5)


def test_fpn_at_sizes_that_are_no_multiple_of_16():
    g = np.random.default_rng(1)
    c2, c3, c4 = (g.normal(size=(2, s, s + 2, c)).astype(np.float32)
                  for s, c in ((25, 64), (13, 128), (7, 256)))
    jmod = JM.LightFPN()
    variables = seeded(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), c2, c3, c4)), 2)
    want = jmod.apply(as_jax(variables), c2, c3, c4)
    tmod = TM.LightFPN((64, 128, 256))
    tmod.load_state_dict(maskrcnn_from_jax(variables))
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, (c2, c3, c4)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # torch's "nearest" would have picked other rows here
    x = torch.arange(7.0).reshape(1, 7, 1, 1)
    exact = TM.upsample_nearest(x, (13, 1))
    plain = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(13, 1)).permute(0, 2, 3, 1)
    want_rows = np.asarray(jax.image.resize(jnp.arange(7.0).reshape(1, 7, 1, 1), (1, 13, 1, 1),
                                            "nearest"))
    np.testing.assert_array_equal(exact.numpy(), want_rows)
    assert not torch.equal(plain, exact)


@pytest.fixture(scope="module")
def pair():
    jmod = JM.MaskRCNN(num_classes=CLASSES, img_size=SIZE, num_proposals=K)
    variables = maskrcnn_variables(jmod)
    model = TM.MaskRCNN(num_classes=CLASSES, img_size=SIZE, num_proposals=K)
    model.load_state_dict(maskrcnn_from_jax(variables))
    return jmod, variables, model


def test_the_model_holds_the_union_of_the_two_inits(pair):
    _, variables, model = pair
    assert set(model.state_dict()) == set(maskrcnn_from_jax(variables))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_and_roi_outputs(pair, train):
    jmod, variables, model = pair
    g = np.random.default_rng(3)
    x = g.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    rois = random_boxes(g, (2, K))
    v = as_jax(variables)
    if train:
        (obj_j, reg_j, p2_j), new = jmod.apply(v, jnp.asarray(x), train=True,
                                               mutable=["batch_stats"])
    else:
        obj_j, reg_j, p2_j = jmod.apply(v, jnp.asarray(x))
    heads_j = jmod.apply(v, p2_j, jnp.asarray(rois), method=jmod.roi_outputs)
    model.train(train)
    with torch.no_grad():
        obj, reg, p2 = model(torch.from_numpy(x))
        heads = model.roi_outputs(p2, torch.from_numpy(rois))
    n_anchors = sum((SIZE // s) ** 2 * 3 for s in (4, 8, 16))
    assert tuple(obj.shape) == (2, n_anchors) and tuple(reg.shape) == (2, n_anchors, 4)
    for a, b in zip((obj, reg, p2, *heads), (obj_j, reg_j, p2_j, *heads_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MODEL_TOL)
    assert tuple(heads[2].shape) == (2, K, 28, 28, CLASSES)
    if train:
        want = maskrcnn_from_jax({"batch_stats": host(new["batch_stats"])})
        for name, buf in model.named_buffers():
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        model.load_state_dict(maskrcnn_from_jax(variables))


def targets_batch():
    """Two images of ``G`` ground-truth slots: image 0 has two ground truths
    that are the same box (one best anchor) and padded rows after them;
    image 1 has a padded row between valid ones."""
    g = np.random.default_rng(4)
    gt = np.zeros((2, G, 4), np.float32)
    labels = np.zeros((2, G), np.int32)
    gt[0, 0] = gt[0, 1] = [0.2, 0.2, 0.5, 0.55]
    gt[0, 2] = [0.55, 0.6, 0.9, 0.95]
    labels[0, :3] = [1, 3, 2]
    gt[1, [0, 2, 3]] = random_boxes(g, (3,))
    labels[1, [0, 2, 3]] = [2, 1, 3]
    masks = np.zeros((2, G, SIZE, SIZE), np.uint8)
    for b in range(2):
        for i in range(G):
            x0, y0, x1, y1 = (gt[b, i] * SIZE).astype(int)
            masks[b, i, y0:y1, x0:x1] = 1
            masks[b, i, y0:(y0 + y1) // 2, x0:(x0 + x1) // 2] = 0     # not box-shaped
    return gt, labels, masks


def test_rpn_targets_with_a_shared_best_anchor_and_padded_rows():
    anchors = TM.generate_anchors(SIZE, sizes=ANCHOR_SIZES)
    gt, labels, _ = targets_batch()
    obj_j, delta_j = jax.vmap(lambda b, l: JM.rpn_targets(jnp.asarray(anchors), b, l))(
        jnp.asarray(gt), jnp.asarray(labels))
    obj, delta = TM.rpn_targets(torch.from_numpy(anchors), torch.from_numpy(gt),
                                torch.from_numpy(labels))
    np.testing.assert_array_equal(obj.numpy(), np.asarray(obj_j))
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j), **EXACT_TOL)
    # anchor 0, which every padded row's argmax claims last, stays unforced
    assert int(obj[0, 0]) == int(obj_j[0, 0])


def test_decode_proposals_takes_the_lower_index_among_ties():
    anchors = TM.generate_anchors(SIZE, sizes=ANCHOR_SIZES)
    g = np.random.default_rng(5)
    a = anchors.shape[0]
    obj = g.uniform(-2, 2, size=(2, a)).astype(np.float32)
    obj[0, ::7] = 3.0                                    # many tied top scores
    obj[1, 100:140] = 2.5
    obj[1, 5] = 2.5
    reg = g.normal(size=(2, a, 4)).astype(np.float32) * 2
    boxes_j, score_j = JM.decode_proposals(jnp.asarray(anchors), jnp.asarray(obj),
                                           jnp.asarray(reg), 24)
    boxes, score = TM.decode_proposals(torch.from_numpy(anchors), torch.from_numpy(obj),
                                       torch.from_numpy(reg), 24)
    np.testing.assert_array_equal(score.numpy(), np.asarray(score_j))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(boxes_j), **EXACT_TOL)
    _, idx_j = jax.lax.top_k(jnp.asarray(obj), 24)
    np.testing.assert_array_equal(np.asarray(idx_j)[0], np.arange(0, 7 * 24, 7))


def test_roi_targets_mask_crops_and_the_loss(pair):
    jmod, variables, model = pair
    gt, labels, masks = targets_batch()
    g = np.random.default_rng(6)
    proposals = np.concatenate([random_boxes(g, (2, K)), gt], axis=1)
    proposals[0, 1] = gt[0, 2] + 0.01
    rl_j, rd_j, gi_j = jax.vmap(JM.roi_targets)(jnp.asarray(proposals), jnp.asarray(gt),
                                                jnp.asarray(labels))
    rl, rd, gi = TM.roi_targets(*map(torch.from_numpy, (proposals, gt, labels)))
    np.testing.assert_array_equal(rl.numpy(), np.asarray(rl_j))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(gi_j))
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), **EXACT_TOL)
    mt_j = jax.vmap(JM.crop_gt_masks)(jnp.asarray(masks), gi_j, jnp.asarray(proposals))
    mt = TM.crop_gt_masks(torch.from_numpy(masks), gi, torch.from_numpy(proposals))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mt_j), **SAMPLE_TOL)
    assert 0.0 < float(mt.mean()) < 1.0

    n = K + G
    args = dict(rpn_obj=g.normal(size=(2, 300)), rpn_reg=g.normal(size=(2, 300, 4)),
                obj_t=g.integers(-1, 2, size=(2, 300)), delta_t=g.normal(size=(2, 300, 4)),
                roi_cls=g.normal(size=(2, n, CLASSES)), roi_reg=g.normal(size=(2, n, 4)),
                roi_labels=rl.numpy(), roi_deltas=rd.numpy(),
                mask_logits=g.normal(size=(2, n, 28, 28, CLASSES)), mask_targets=mt.numpy())
    args = {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in args.items()}
    total_j, terms_j = JM.mask_rcnn_loss(**{k: jnp.asarray(v) for k, v in args.items()})
    total, terms = TM.mask_rcnn_loss(**{k: torch.from_numpy(v) for k, v in args.items()})
    assert set(terms) == set(terms_j)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(terms_j[k]), **TOL, err_msg=k)
    assert float(total) == float(terms["loss"])


def test_import_torchvision_resnet_fills_layer2_and_layer3_as_the_jax_import_does(pair):
    from test_torch_ssd import torchvision_state_dict

    jmod, variables, _ = pair
    sd = torchvision_state_dict("resnet18", 7)
    jout, jn = jr.import_torchvision_resnet(dict(variables), sd)
    model = TM.MaskRCNN(num_classes=CLASSES, img_size=SIZE, num_proposals=K)
    model.load_state_dict(maskrcnn_from_jax(variables))
    n = tr.import_torchvision_resnet(model, sd)
    assert n == jn == 75                    # the stem, layer2 and layer3: 25 tensors each
    want = maskrcnn_from_jax(host(jout))
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
