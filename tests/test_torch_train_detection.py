"""The port's SSD trainer (``train/detection.py``) against the JAX
package's: two steps of ``make_train_step`` from the same seeded weights at
300 px, batch 2 (each step's loss, the batch-norm statistics after it, the
SGD momentum trace and the parameters' change); the warmup schedule
(optax's ``linear_schedule`` counts the updates made before the step);
``evaluate`` on one fixed set of weights, and on fixed model outputs near
the ground truth, so that NMS, the top ``max_det`` and the AP see real
detections; the command line on the CPU, its ``--size`` check and the
default device.

Tolerances: the losses rtol 1e-5; statistics within 1e-4 of their largest
element; the momentum trace (the gradient after step 1) as one vector
within 1e-2 of its norm, each tensor within 3e-2 of its own norm or of the
mean norm a tensor; the parameters' change within 1e-2 of its norm; the
eval numbers within 1e-6.  The gradient is ill-conditioned at this size:
train-mode batch norms at batch 2 down to a 1x1 map, where each channel
normalises two values.  Measured 4.2e-3 between the two sides, where the
JAX side lies 4.2e-3 and the port 1.1e-3 from a float64 backward of the
port's model (the gradient of the loss in the model's outputs agrees to
3e-8).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqvae2_tpu.detection import boxes as JB
from vqvae2_tpu.detection.ssd import SSD300 as JSSD300
from vqvae2_tpu.train import detection as jdet
from vqvae2_tpu_torch.detection import boxes as TB
from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco
from vqvae2_tpu_torch.detection.ssd import SSD300
from vqvae2_tpu_torch.train import detection as tdet
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import ssd_from_jax

from test_torch_ssd import seeded

CLASSES = 14
LR, TOTAL = 0.002, 40
LOSS_RTOL = 1e-5
STATS_RTOL = 1e-4
GRAD_RTOL, TENSOR_RTOL, STEP_RTOL = 1e-2, 3e-2, 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    img_dir, ann = make_synthetic_coco(str(tmp_path_factory.mktemp("coco")), n=4, size=300)
    return CocoDetectionDataset(img_dir, ann, size=300)


def test_the_schedule_is_optaxs():
    warmup = min(1000, TOTAL // 10 + 1)
    jax_sched = optax.linear_schedule(LR / 100, LR, warmup)
    port = schedules.linear_schedule(LR / 100, LR, warmup)
    for step in range(0, 12):
        assert port(step) == float(jax_sched(step)), step
    tx = tdet.make_optimizer(LR, TOTAL)
    assert not tx.nesterov and tx.momentum == 0.9


def norms_close(got: dict, want: dict, rtol: float, tensor_rtol: float, what: str):
    err = sum(float(torch.sum((got[k] - want[k]).double() ** 2)) for k in want) ** 0.5
    norm = sum(float(torch.sum(want[k].double() ** 2)) for k in want) ** 0.5
    assert err <= rtol * norm, (what, err / norm)
    mean = norm / len(want) ** 0.5
    for k in want:
        e, own = float(torch.linalg.norm((got[k] - want[k]).double())), float(
            torch.linalg.norm(want[k].double()))
        assert e <= tensor_rtol * max(own, mean), (what, k, e, own)


def test_two_steps_against_jax(coco):
    jmodel = JSSD300(num_classes=CLASSES)
    variables = seeded(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 300, 300, 3)))), 11)
    warmup = min(1000, TOTAL // 10 + 1)
    tx = optax.sgd(optax.linear_schedule(LR / 100, LR, warmup), momentum=0.9)
    dboxes = JB.default_boxes_ssd300()
    jstate = jdet.DetState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=tx.init(variables["params"]))
    jstep = jdet.make_train_step(jmodel, tx, dboxes)

    model = SSD300(num_classes=CLASSES)
    model.load_state_dict(ssd_from_jax(variables))
    ttx = tdet.make_optimizer(LR, TOTAL)
    state = tdet.create_state(model, ttx)
    tstep = tdet.make_train_step(model, ttx, dboxes)

    batches = list(coco.batches(2, seed=3))[:2]
    params_before = {k: v.clone() for k, v in model.state_dict().items()}
    want_before = ssd_from_jax(variables)
    for imgs, gt_boxes, gt_labels, _ in batches:
        jstate, jloss = jstep(jstate, jnp.asarray(imgs), jnp.asarray(gt_boxes),
                              jnp.asarray(gt_labels))
        state, loss = tstep(state, *map(torch.from_numpy, (imgs, gt_boxes, gt_labels)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        want = ssd_from_jax({"params": host(jstate.params),
                             "batch_stats": host(jstate.batch_stats)})
        for name, buf in model.named_buffers():
            err = float((buf - want[name]).abs().max())
            assert err <= STATS_RTOL * float(want[name].abs().max()), (name, err)
        trace = ssd_from_jax({"params": host(jstate.opt_state[0].trace)})
        got = {n: state.optimizer.state[p]["momentum_buffer"]
               for n, p in model.named_parameters()}
        norms_close(got, trace, GRAD_RTOL, TENSOR_RTOL, f"trace after step {state.step}")
        names = [n for n, _ in model.named_parameters()]
        now = model.state_dict()
        norms_close({n: now[n] - params_before[n] for n in names},
                    {n: want[n] - want_before[n] for n in names}, STEP_RTOL, TENSOR_RTOL,
                    f"change after step {state.step}")
    assert state.step == 2 == int(jstate.step)


class FixedSSD(torch.nn.Module):
    """Model outputs fixed in advance (the same on both sides)."""

    def __init__(self, loc, conf):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.loc, self.conf = torch.from_numpy(loc), torch.from_numpy(conf)

    def forward(self, imgs):
        return self.loc[: imgs.shape[0]], self.conf[: imgs.shape[0]]


def outputs_near_the_truth(coco, g):
    """loc/conf of a detector that has nearly learnt ``coco``'s 4 images."""
    db = TB.default_boxes_ssd300()
    imgs, gt_boxes, gt_labels, _ = next(coco.batches(4, shuffle=False))
    loc_t, cls_t = TB.encode_targets(torch.from_numpy(gt_boxes), torch.from_numpy(gt_labels),
                                     TB.ltrb_from_cxcywh(torch.from_numpy(db)),
                                     torch.from_numpy(db))
    loc = (loc_t.numpy() + 0.3 * g.normal(size=loc_t.shape)).astype(np.float32)
    conf = 4.0 * np.eye(CLASSES, dtype=np.float32)[cls_t.numpy()]
    conf += g.normal(size=conf.shape).astype(np.float32)
    return loc, conf


@pytest.mark.parametrize("weights", ["seeded", "near the truth"])
def test_evaluate_against_jax(coco, weights):
    dboxes = JB.default_boxes_ssd300()
    g = np.random.default_rng(5)
    if weights == "seeded":
        jmodel = JSSD300(num_classes=CLASSES)
        variables = seeded(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                              jnp.zeros((1, 300, 300, 3)))), 12)
        jstate = types.SimpleNamespace(params=variables["params"],
                                       batch_stats=variables["batch_stats"])
        model = SSD300(num_classes=CLASSES)
        model.load_state_dict(ssd_from_jax(variables))
    else:
        loc, conf = outputs_near_the_truth(coco, g)
        jmodel = types.SimpleNamespace(apply=lambda v, imgs: (jnp.asarray(loc)[: imgs.shape[0]],
                                                              jnp.asarray(conf)[: imgs.shape[0]]))
        jstate = types.SimpleNamespace(params={}, batch_stats={})
        model = FixedSSD(loc, conf)
    want = jdet.evaluate(jmodel, jstate, coco, dboxes, batch_size=4)
    got = tdet.evaluate(model, None, coco, dboxes, batch_size=4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    if weights == "near the truth":
        assert got["AP50"] > 0.5, got
    assert model.training                              # evaluate restores the mode


def test_the_command_line_on_the_cpu(tmp_path):
    csv = str(tmp_path / "steps.csv")
    m = tdet.main(["--synthetic", "--steps", "2", "--batch_size", "2", "--device", "cpu",
                   "--log_every", "1", "--metrics_csv", csv, "--eval"])
    assert np.isfinite(m["loss"]) and 0.0 <= m["mAP"] <= 1.0 and 0.0 <= m["AP50"] <= 1.0
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 3
    with pytest.raises(SystemExit, match="300px"):
        tdet.main(["--synthetic", "--steps", "1", "--size", "64", "--device", "cpu"])
    args = tdet.build_argparser().parse_args([])
    assert args.device == "cuda" and args.size == 300 and args.batch_size == 8


def test_the_flags_are_the_jax_trainers_and_device():
    ours = {a.dest: a.default for a in tdet.build_argparser()._actions}
    theirs = {a.dest: a.default for a in jdet.build_argparser()._actions}
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs
