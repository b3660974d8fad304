"""The port's Mask R-CNN trainer (``train/maskrcnn.py``) against the JAX
package's: two steps of ``make_train_step`` from the same seeded weights at
64 px, batch 2, 8 proposals and 8 ground-truth slots (each of the five loss
terms and their sum, the batch-norm statistics, Adam's first moment and
count); ``evaluate_instances`` on one fixed set of weights and on fixed
model outputs near the ground truth (box AP, mask AP and the mean mask IoU
of real detections); ``_paste_mask`` against the JAX package's ``cv2.resize``
version; the command line on the CPU and the default device.

Tolerances: the loss terms rtol 1e-4 / atol 1e-6; statistics within 1e-4
of their largest element; Adam's first moment (0.1 of the gradient after
step 1) as one vector within 1e-2 of its norm, each tensor within 3e-2 of
its own norm or of the mean norm a tensor (train-mode batch norms at batch
2, as in the SSD trainer's test); the eval numbers within 1e-6; the pasted
masks' resize within 2e-6 with no pixel flipped at the threshold.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae2_tpu.detection import mask_rcnn as JM
from vqvae2_tpu.train import maskrcnn as jmr
from vqvae2_tpu_torch.detection import mask_rcnn as TM
from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco
from vqvae2_tpu_torch.train import maskrcnn as tmr
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import maskrcnn_from_jax

from test_torch_mask_rcnn import host, maskrcnn_variables
from test_torch_train_detection import norms_close

SIZE, K, MAX_BOXES, LR = 64, 8, 8, 1e-4
ANCHOR_SIZES = (8, 16, 32)
CLASSES = 4
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
STATS_RTOL = 1e-4
GRAD_RTOL, TENSOR_RTOL = 1e-2, 3e-2


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    img_dir, ann = make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), n=4, size=SIZE,
                                       n_classes=CLASSES - 1, with_masks=True)
    return CocoDetectionDataset(img_dir, ann, size=SIZE, with_masks=True, max_boxes=MAX_BOXES)


def jax_model():
    return JM.MaskRCNN(num_classes=CLASSES, img_size=SIZE, num_proposals=K)


def port_model(variables):
    model = TM.MaskRCNN(num_classes=CLASSES, img_size=SIZE, num_proposals=K)
    model.load_state_dict(maskrcnn_from_jax(variables))
    return model


def test_two_steps_against_jax(coco):
    jmodel = jax_model()
    variables = maskrcnn_variables(jmodel, seed=21)
    anchors = JM.generate_anchors(SIZE, sizes=ANCHOR_SIZES)
    tx = optax.adam(LR)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = jmr.MRState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                         opt_state=tx.init(params))
    jstep = jmr.make_train_step(jmodel, tx, anchors)

    model = port_model(variables)
    ttx = schedules.adam(LR)
    state = tmr.create_state(model, ttx)
    tstep = tmr.make_train_step(model, ttx, anchors)
    for imgs, gt_boxes, gt_labels, _, gt_masks in list(coco.batches(2, seed=4,
                                                                    with_masks=True))[:2]:
        batch = (imgs, gt_boxes, gt_labels, gt_masks)
        jstate, jm = jstep(jstate, *map(jnp.asarray, batch))
        state, m = tstep(state, *map(torch.from_numpy, batch))
        assert set(m) == set(jm) == {"rpn_cls", "rpn_reg", "roi_cls", "roi_reg", "mask", "loss"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(float(m["loss"]),
                                   sum(float(m[k]) for k in m if k != "loss"), rtol=1e-6)
        want = maskrcnn_from_jax({"params": host(jstate.params),
                                  "batch_stats": host(jstate.batch_stats)})
        for name, buf in model.named_buffers():
            err = float((buf - want[name]).abs().max())
            assert err <= STATS_RTOL * float(want[name].abs().max()), (name, err)
        adam = jstate.opt_state[0]
        mu = maskrcnn_from_jax({"params": host(adam.mu)})
        got = {n: state.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()}
        assert {int(state.optimizer.state[p]["step"]) for p in model.parameters()} == {
            int(adam.count)}
        norms_close(got, mu, GRAD_RTOL, TENSOR_RTOL, f"first moment after step {state.step}")
    assert state.step == 2


class FixedMaskRCNN(torch.nn.Module):
    """Model outputs fixed in advance (the same on both sides)."""

    def __init__(self, out):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.out = {k: torch.from_numpy(v) for k, v in out.items()}
        self.num_proposals = out["roi_cls"].shape[1]

    def forward(self, imgs):
        return self.out["rpn_obj"], self.out["rpn_reg"], self.out["p2"]

    def roi_outputs(self, p2, rois):
        return self.out["roi_cls"], self.out["roi_reg"], self.out["masks"]


def outputs_near_the_truth(coco, g):
    """A forward whose proposals are anchors and whose heads score each
    proposal's matched ground truth, move it onto that ground truth and
    paint a mask over the box but its top rows."""
    imgs, gt_boxes, gt_labels, _, gt_masks = next(coco.batches(4, shuffle=False,
                                                               with_masks=True))
    anchors = TM.generate_anchors(SIZE, sizes=ANCHOR_SIZES)
    n = 48
    pick = np.stack([g.choice(len(anchors), n, replace=False) for _ in range(4)])
    rpn_obj = np.full((4, len(anchors)), -5.0, np.float32)
    for b in range(4):
        rpn_obj[b, pick[b]] = np.linspace(5, 1, n)
    rpn_reg = np.zeros((4, len(anchors), 4), np.float32)
    props, _ = TM.decode_proposals(torch.from_numpy(anchors), torch.from_numpy(rpn_obj),
                                   torch.from_numpy(rpn_reg), n)
    labels, deltas, _ = TM.roi_targets(props, torch.from_numpy(gt_boxes),
                                            torch.from_numpy(gt_labels), pos_iou=0.3)
    roi_cls = 4.0 * np.eye(CLASSES, dtype=np.float32)[labels.numpy()]
    roi_cls += g.normal(size=roi_cls.shape).astype(np.float32)
    # the synthetic masks are box-shaped: a mask that fills its refined box
    masks = 3.0 + 0.5 * g.normal(size=(4, n, 28, 28, CLASSES))
    masks[:, :, :2] = -3.0
    return {"rpn_obj": rpn_obj, "rpn_reg": rpn_reg,
            "p2": np.zeros((4, SIZE // 4, SIZE // 4, 128), np.float32),
            "roi_cls": roi_cls, "roi_reg": deltas.numpy(), "masks": masks.astype(np.float32)}


@pytest.mark.parametrize("weights", ["seeded", "near the truth"])
def test_evaluate_instances_against_jax(coco, weights):
    anchors = JM.generate_anchors(SIZE, sizes=ANCHOR_SIZES)
    if weights == "seeded":
        jmodel = jax_model()
        variables = maskrcnn_variables(jmodel, seed=22)
        jstate = types.SimpleNamespace(params=variables["params"],
                                       batch_stats=variables["batch_stats"])
        model = port_model(variables)
    else:
        out = outputs_near_the_truth(coco, np.random.default_rng(8))

        def apply(v, *args, method=None):
            if method is None:
                return tuple(jnp.asarray(out[k]) for k in ("rpn_obj", "rpn_reg", "p2"))
            return tuple(jnp.asarray(out[k]) for k in ("roi_cls", "roi_reg", "masks"))

        jmodel = types.SimpleNamespace(apply=apply, roi_outputs="roi_outputs",
                                       num_proposals=out["roi_cls"].shape[1])
        jstate = types.SimpleNamespace(params={}, batch_stats={})
        model = FixedMaskRCNN(out)
    want = jmr.evaluate_instances(jmodel, jstate, coco, anchors, batch_size=4)
    got = tmr.evaluate_instances(model, None, coco, anchors, batch_size=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    if weights == "near the truth":
        assert got["AP50"] > 0.3 and got["mask_mIoU"] > 0.5, got
    assert model.training


@pytest.mark.parametrize("box", [(0.1, 0.1, 0.9, 0.9), (0.05, 0.3, 0.4, 0.9),
                                 (0.0, 0.0, 0.02, 0.5), (0.5, 0.5, 0.5, 0.9),
                                 (0.37, 0.12, 0.99, 0.81)])
def test_paste_mask_is_the_cv2_resize(box):
    g = np.random.default_rng(9)
    mask = g.uniform(size=(28, 28)).astype(np.float32)
    box = np.asarray(box, np.float32)
    size = 200
    got = tmr._paste_mask(mask, box, size, 0.5)
    want = jmr._paste_mask(mask, box, size, 0.5)
    np.testing.assert_array_equal(got, want)
    x0, y0, x1, y1 = (np.clip(box, 0, 1) * size).astype(int)
    if x1 > x0 and y1 > y0:
        import cv2

        m = torch.nn.functional.interpolate(torch.from_numpy(mask)[None, None],
                                            size=(y1 - y0, x1 - x0), mode="bilinear",
                                            align_corners=False)[0, 0].numpy()
        assert float(np.abs(m - cv2.resize(mask, (x1 - x0, y1 - y0))).max()) <= 2e-6


def test_the_command_line_on_the_cpu(tmp_path):
    csv = str(tmp_path / "steps.csv")
    m = tmr.main(["--synthetic", "--steps", "2", "--size", "64", "--anchor_sizes", "8,16,32",
                  "--batch_size", "2", "--max_boxes", "8", "--num_proposals", "8",
                  "--device", "cpu", "--log_every", "1", "--metrics_csv", csv, "--eval"])
    terms = ("rpn_cls", "rpn_reg", "roi_cls", "roi_reg", "mask")
    assert all(np.isfinite(m[k]) for k in terms)
    np.testing.assert_allclose(m["loss"], sum(m[k] for k in terms), rtol=1e-6)
    for k in ("mAP", "mask_mAP", "mask_mIoU"):
        assert 0.0 <= m[k] <= 1.0, (k, m[k])
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 3
    args = tmr.build_argparser().parse_args([])
    assert args.device == "cuda" and args.size == 256 and args.num_proposals == 64


def test_the_flags_are_the_jax_trainers_and_device():
    ours = {a.dest: a.default for a in tmr.build_argparser()._actions}
    theirs = {a.dest: a.default for a in jmr.build_argparser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
