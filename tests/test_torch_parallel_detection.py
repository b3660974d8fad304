"""The detection trainers at world size N (``gloo`` ranks on the CPU, spawned
once a size by ``torch_parallel_ranks``) against the same step in one process
and against the JAX package's step on a batch that ``vqvae2_tpu.parallel.
shard_batch`` lays over its 8 virtual devices.

* SSD300 (resnet18, 14 classes) at 300 px, batch 8 (4 + 4 and 3 + 3 + 2
  images): the MultiBox loss is a mean over the images, so each rank
  backpropagates its share; the batch norms take the global moments.
* Mask R-CNN at 64 px, batch 8, 8 proposals and 8 ground-truth slots: the
  loss's counts (valid and positive anchors, positive and negative RoIs) are
  summed over the ranks.

Tolerances:
- against the JAX step, those of ``tests/test_torch_train_detection.py`` and
  ``tests/test_torch_train_maskrcnn.py``: the SSD loss rtol 1e-5, Mask
  R-CNN's terms rtol 1e-4 / atol 1e-6; the batch-norm statistics within 1e-4
  of their largest element; the gradient (SGD's momentum trace after one
  step; Adam's first moment is 0.1 of it) as one vector within 1e-2 of its
  norm, each tensor within 3e-2 of its own norm or of the mean norm a tensor;
- against the one-process port step: the losses rtol 1e-5 and the
  statistics within 1e-5 of their largest element; the gradient as against
  JAX (train-mode batch norms over few rows: an ill-conditioned gradient
  that a sum in another order moves);
- every rank's parameters, buffers and gradients bit-equal to rank 0's (by
  digests: the other ranks return those and their metrics); a group of one
  rank bit-equal to no group.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from test_torch_mask_rcnn import maskrcnn_variables
from test_torch_ssd import seeded
from test_torch_train_detection import norms_close
from vqvae2_tpu import parallel as jpar
from vqvae2_tpu.detection import boxes as JB
from vqvae2_tpu.detection import mask_rcnn as JM
from vqvae2_tpu.detection.ssd import SSD300 as JSSD300
from vqvae2_tpu.train import detection as jdet
from vqvae2_tpu.train import maskrcnn as jmr
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco
from vqvae2_tpu_torch.utils.jax_import import maskrcnn_from_jax, ssd_from_jax

CLASSES, LR, TOTAL, BATCH = 14, 0.002, 40, 8
MR = dict(num_classes=4, img_size=64, num_proposals=8)
ANCHOR_SIZES, MAX_BOXES = (8, 16, 32), 8
LOSS_RTOL, MR_LOSS_TOL = 1e-5, dict(rtol=1e-4, atol=1e-6)
STATS_RTOL, PORT_STATS_RTOL = 1e-4, 1e-5
GRAD_RTOL, TENSOR_RTOL = 1e-2, 3e-2


_SCRATCH = []


def scratch_dir(name: str) -> str:
    """A directory for this module's data, removed when the process ends."""
    d = tempfile.TemporaryDirectory(prefix=f"{name}_")
    _SCRATCH.append(d)
    return d.name


@functools.lru_cache(maxsize=None)
def ssd_data():
    img_dir, ann = make_synthetic_coco(scratch_dir("coco"), n=BATCH, size=300)
    ds = CocoDetectionDataset(img_dir, ann, size=300)
    imgs, boxes, labels, _ = next(ds.batches(BATCH, seed=3))
    jmodel = JSSD300(num_classes=CLASSES)
    variables = seeded(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 300, 300, 3)))), 11)
    return jmodel, variables, (imgs, boxes, labels)


@functools.lru_cache(maxsize=None)
def mr_data():
    img_dir, ann = make_synthetic_coco(scratch_dir("coco_mr"), n=BATCH, size=64,
                                       n_classes=MR["num_classes"] - 1, with_masks=True)
    ds = CocoDetectionDataset(img_dir, ann, size=64, with_masks=True, max_boxes=MAX_BOXES)
    imgs, boxes, labels, _, masks = next(ds.batches(BATCH, seed=4, with_masks=True))
    jmodel = JM.MaskRCNN(**MR)
    return jmodel, maskrcnn_variables(jmodel, seed=21), (imgs, boxes, labels, masks)


def jobs():
    _, sv, sb = ssd_data()
    _, mv, mb = mr_data()
    anchors = JM.generate_anchors(64, sizes=ANCHOR_SIZES)
    return [("ssd_step", (ssd_from_jax(sv), CLASSES, LR, TOTAL, sb)),
            ("maskrcnn_step", (maskrcnn_from_jax(mv), MR, anchors, mb))]


@functools.lru_cache(maxsize=None)
def one_process():
    return [getattr(ranks, name)(0, 1, *args) for name, args in jobs()]


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@functools.lru_cache(maxsize=None)
def jax_ssd():
    jmodel, variables, batch = ssd_data()
    warmup = min(1000, TOTAL // 10 + 1)
    tx = optax.sgd(optax.linear_schedule(LR / 100, LR, warmup), momentum=0.9)
    state = jdet.DetState(step=jnp.zeros((), jnp.int32),
                          params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]),
                          opt_state=tx.init(variables["params"]))
    mesh = jpar.make_mesh(jax.devices())
    state, loss = jdet.make_train_step(jmodel, tx, JB.default_boxes_ssd300())(
        state, *jpar.shard_batch(batch, mesh))
    return (float(loss), ssd_from_jax({"params": host(state.opt_state[0].trace)}),
            ssd_from_jax({"params": host(state.params), "batch_stats": host(state.batch_stats)}))


@functools.lru_cache(maxsize=None)
def jax_maskrcnn():
    jmodel, variables, batch = mr_data()
    tx = optax.adam(1e-4)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jmr.MRState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                        opt_state=tx.init(params))
    anchors = JM.generate_anchors(64, sizes=ANCHOR_SIZES)
    state, metrics = jmr.make_train_step(jmodel, tx, anchors)(
        state, *jpar.shard_batch(batch, jpar.make_mesh(jax.devices())))
    mu = maskrcnn_from_jax({"params": host(state.opt_state[0].mu)})
    return ({k: float(v) for k, v in metrics.items()}, {k: v / 0.1 for k, v in mu.items()},
            maskrcnn_from_jax({"params": host(state.params),
                               "batch_stats": host(state.batch_stats)}))


@pytest.fixture(scope="module")
def single():
    return one_process()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 3 ranks; the JAX steps and the one-process steps
    run here meanwhile."""
    return ranks.run_worlds((2, 3), tmp_path_factory, jobs(),
                            meanwhile=lambda: (jax_ssd(), jax_maskrcnn(), one_process()))


@pytest.fixture(scope="module", params=[2, 3])
def world(request, worlds):
    return request.param, worlds[request.param]


def buffers_close(got: dict, want: dict, rtol: float):
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            err = float((got[name] - w).abs().max())
            assert err <= rtol * float(w.abs().max()), (name, err)


def test_ssd_step_is_the_jax_sharded_step(world):
    """Rank 0's step (every rank's is rank 0's, below)."""
    n, results = world
    loss, grads, after = jax_ssd()
    got = results[0][0]
    np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=LOSS_RTOL)
    buffers_close(got["state"], after, STATS_RTOL)
    norms_close(got["grads"], grads, GRAD_RTOL, TENSOR_RTOL, f"SSD gradient, world {n}")


def test_maskrcnn_step_is_the_jax_sharded_step(world):
    n, results = world
    metrics, grads, after = jax_maskrcnn()
    got = results[0][1]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, **MR_LOSS_TOL, err_msg=k)
    buffers_close(got["state"], after, STATS_RTOL)
    norms_close(got["grads"], grads, GRAD_RTOL, TENSOR_RTOL, f"Mask R-CNN gradient, world {n}")


@pytest.mark.parametrize("job", [0, 1], ids=["ssd", "maskrcnn"])
def test_steps_are_the_single_process_steps(world, single, job):
    n, results = world
    want = single[job]
    for res in results:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(res[job]["metrics"][k], v, rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=k)
    got = results[0][job]
    buffers_close(got["state"], want["state"], PORT_STATS_RTOL)
    norms_close(got["grads"], want["grads"], GRAD_RTOL, TENSOR_RTOL, f"world {n}")


def test_every_rank_holds_rank_0s_state(world):
    """Parameters, buffers and gradients, bit for bit (by digests)."""
    n, results = world
    for job in (0, 1):
        assert results[0][job]["digests"] == ranks.slim(0, results[0][job])["digests"]
        for res in results[1:]:
            assert res[job]["digests"] == results[0][job]["digests"], job


def test_a_world_of_one_is_bit_equal_to_no_group(tmp_path, single):
    par.init_distributed("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        got = [getattr(ranks, name)(0, 1, *args) for name, args in jobs()]
    finally:
        dist.destroy_process_group()
    for job in (0, 1):
        assert got[job]["metrics"] == single[job]["metrics"]
        for part in ("state", "grads"):
            for k, v in single[job][part].items():
                assert torch.equal(got[job][part][k], v), (job, part, k)


def test_launch_forms_a_torchrun_world_of_one(monkeypatch):
    """``train.detection.main`` through ``launch`` under a ``torchrun``
    environment of one rank (``gloo`` for ``--device cpu``) returns the
    losses of a run without one, and leaves no group behind."""
    import socket

    from vqvae2_tpu_torch.train import detection as tdet

    argv = ["--synthetic", "--steps", "2", "--batch_size", "2", "--log_every", "1",
            "--device", "cpu"]
    alone = tdet.main(argv)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(tdet, "train", lambda args, f=tdet.train: seen.append(
        (par.is_initialized(), dist.get_backend())) or f(args))
    grouped = tdet.main(argv)
    assert seen == [(True, "gloo")] and not par.is_initialized()
    assert grouped == alone
