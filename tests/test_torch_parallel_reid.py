"""The ReID trainer at world size N (``gloo`` ranks on the CPU, spawned once a
size by ``torch_parallel_ranks``) against the same step in one process and
against the JAX package's step on a batch that ``vqvae2_tpu.parallel.
shard_batch`` lays over its 8 virtual devices; and the Lovasz loss at world N
against the JAX package's ``lovasz_softmax`` on the global batch.

Model: ``EmbedNet2`` (resnet18) at 64x32, P = 2 identities of K = 4 images (8
rows a modality, 24 images: 4 + 4 and 3 + 3 + 2 rows of each modality), the
weights of ``tests/test_torch_train_reid.py`` carried across by
``embed_net2_from_jax``.  One SGD step without the parsing head's dropout
(flax's ``nn.Dropout`` and the port's ``part_model.dropout`` the identity, as
in that file), and one of two microbatches with the dropout on, whose masks
each rank draws for the global batch.

Tolerances:
- against the JAX step, those of ``tests/test_torch_train_reid.py``: the
  metrics rtol 1e-4 / atol 1e-5; a step's change of one learning-rate
  group's parameters within 3e-2 of its norm, each tensor's within 1e-1 of
  its own norm or of the group's mean norm a tensor; the batch-norm buffers
  within 1e-4 of their largest element;
- against the one-process port step: the metrics rtol 1e-5 and the
  batch-norm buffers within 1e-5 of their largest element (the moments are
  summed over the ranks in another order); the parameters as against JAX
  (the fp32 gradient of this train-mode network is ill-conditioned: a sum in
  another order moves single tensors by a few per cent);
- every rank's parameters, buffers and gradients bit-equal to rank 0's (by
  digests: the other ranks return those and their metrics);
- Lovasz: the value rtol 1e-6 and the gradient rtol 1e-5 / atol 1e-7 of the
  JAX loss on the global batch, its probabilities drawn from a few levels so
  that errors tie.
"""

import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from test_torch_train_reid import assert_same_state, jax_state, seeded
from vqvae2_tpu import parallel as jpar
from vqvae2_tpu.part.lovasz import lovasz_softmax as jax_lovasz
from vqvae2_tpu.part.part_model import EmbedNet2 as JEmbedNet2
from vqvae2_tpu.train import reid as jtr
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.train import reid as ttr
from vqvae2_tpu_torch.utils.jax_import import embed_net2_from_jax

HW = (64, 32)
P, K = 2, 4
CFG = dict(classes=3, arch="resnet18", lr=0.1, P=P, K=K, hw=HW, seed=5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PORT_METRIC_TOL = dict(rtol=1e-5, atol=1e-7)
PORT_BUFFER_RTOL = 1e-5


_SCRATCH = []


def scratch_dir(name: str) -> str:
    """A directory for this module's data, removed when the process ends."""
    d = tempfile.TemporaryDirectory(prefix=f"{name}_")
    _SCRATCH.append(d)
    return d.name


@functools.lru_cache(maxsize=None)
def sysu_dir():
    return jtr.make_synthetic_sysu(scratch_dir("sysu"), n_ids=3, per_id=4,
                                   h=HW[0], w=HW[1])


def batches(n, seed):
    ds = tsysu.SYSUData(sysu_dir(), part=True, seed=seed)
    ds.samplize(P, K)
    it = tds.epoch_row_batches(ds, P * K)
    out = [ttr.collate(next(it), HW) for _ in range(n)]
    it.close()
    return out


@functools.lru_cache(maxsize=None)
def start():
    jmod = JEmbedNet2(class_num=3, arch="resnet18")
    probe = jnp.zeros((1, *HW, 3))
    variables = seeded(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), xRGB=probe, xIR=probe, xZ=probe, modal=0, train=True)), 11)
    return jmod, variables


def lovasz_case():
    """Three blocks of 5 rows of 4x3 pixels, 4 classes; the probabilities
    are drawn from five levels, so many errors tie; some pixels ignored."""
    g = np.random.default_rng(2)
    levels = np.array([0.1, 0.2, 0.3, 0.5, 0.7], np.float32)
    probas = levels[g.integers(0, 5, size=(15, 4, 3, 4))]
    labels = g.integers(0, 4, size=(15, 4, 3)).astype(np.int64)
    labels[g.random(labels.shape) < 0.15] = 255
    return probas, labels


def jobs():
    sd = embed_net2_from_jax(start()[1])
    return [("reid_step", (sd, CFG, batches(1, 0), 1, False)),
            ("reid_step", (sd, CFG, batches(2, 1), 2, True)),
            ("lovasz_world", (*lovasz_case(), 3))]


@functools.lru_cache(maxsize=None)
def one_process():
    return [getattr(ranks, name)(0, 1, *args) for name, args in jobs()]


@pytest.fixture(scope="module")
def single():
    return one_process()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 3 ranks; the JAX step and the one-process step
    run here meanwhile."""
    return ranks.run_worlds((2, 3), tmp_path_factory, jobs(),
                            meanwhile=lambda: (jax_step(), one_process()))


@pytest.fixture(scope="module", params=[2, 3])
def world(request, worlds):
    return request.param, worlds[request.param]


@functools.lru_cache(maxsize=None)
def jax_step():
    """The JAX step on the batch laid over the 8 virtual devices, without
    the dropout: the metrics, and the variables before and after."""
    import flax.linen as fnn

    jmod, variables = start()
    saved = fnn.Dropout.__call__
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        tx, state = jax_state(jmod, variables)
        before = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                     "batch_stats": state.batch_stats})
        mesh = jpar.make_mesh(jax.devices())
        batch = jpar.shard_batch(batches(1, 0)[0], mesh)
        state, metrics = jtr.make_train_step(jmod, tx, K, P, HW)(state, batch,
                                                                  jax.random.PRNGKey(0))
        after = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    finally:
        fnn.Dropout.__call__ = saved
    return {k: float(v) for k, v in metrics.items()}, before, after


def port_model(state_dict):
    model = ttr.EmbedNet2(class_num=3, arch="resnet18")
    model.load_state_dict(state_dict)
    return model


def test_reid_step_is_the_jax_sharded_step(world):
    """Rank 0's step (every rank's is rank 0's, below)."""
    n, results = world
    metrics, before, after = jax_step()
    got = results[0][0]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, **METRIC_TOL, err_msg=k)
    assert_same_state(port_model(got["state"]), embed_net2_from_jax(before), after, before)


def assert_port_steps_agree(got, want):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, **PORT_METRIC_TOL, err_msg=k)
    for name, buf in want["state"].items():
        if "running" in name:
            err = float((got["state"][name] - buf).abs().max())
            assert err <= PORT_BUFFER_RTOL * float(buf.abs().max()), (name, err)


def test_reid_step_is_the_single_process_step(world, single):
    n, results = world
    for job in (0, 1):
        assert_port_steps_agree(results[0][job], single[job])
        for res in results[1:]:
            assert res[job]["metrics"] == results[0][job]["metrics"]


def test_grad_accum_with_dropout_moves_the_parameters_as_one_process(world, single):
    """Two microbatches, the dropout on: each rank draws the global batch's
    mask; each learning-rate group's change is one process's (the
    tolerances against JAX)."""
    n, results = world
    start_sd = embed_net2_from_jax(start()[1])
    want = single[1]["state"]
    for res in results[:1]:
        got = res[1]["state"]
        groups = {}
        for name, _ in port_model(start_sd).named_parameters():
            groups.setdefault(ttr.param_group(name), []).append(
                ((got[name] - start_sd[name]).double(), (want[name] - start_sd[name]).double()))
        for group, items in groups.items():
            err = float(sum(torch.sum((a - b) ** 2) for a, b in items)) ** 0.5
            norm = float(sum(torch.sum(b ** 2) for _, b in items)) ** 0.5
            assert err <= 3e-2 * norm, (group, err, norm)
            mean_norm = norm / len(items) ** 0.5
            for a, b in items:
                assert float((a - b).norm()) <= 1e-1 * max(float(b.norm()), mean_norm)


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
    assert got[2]["share"] == single[2]["share"]
    assert torch.equal(got[2]["grad"], single[2]["grad"])


def test_lovasz_at_world_n_is_jaxs_on_the_global_batch(world, single):
    """Each rank's share sums to the JAX loss of the global batch (its
    blocks in the global order), and the rank's gradient is JAX's on its
    own pixels, ties broken in JAX's order."""
    n, results = world
    probas, labels = lovasz_case()
    value, grad = jax.value_and_grad(jax_lovasz)(jnp.asarray(probas), jnp.asarray(labels))
    grad = np.asarray(grad)
    rows = probas.shape[0] // 3
    for r, res in enumerate(results):
        got = res[2]
        np.testing.assert_allclose(got["total"], float(value), rtol=1e-6)
        start_, stop = par.shard_rows(rows, par.Mesh(n, r, torch.device("cpu")))
        own = np.concatenate([grad[g * rows + start_:g * rows + stop] for g in range(3)])
        np.testing.assert_allclose(got["grad"].numpy(), own, rtol=1e-5, atol=1e-7)
    assert sum(res[2]["share"] for res in results) == pytest.approx(float(value), rel=1e-6)
    np.testing.assert_allclose(single[2]["grad"].numpy(), grad, rtol=1e-5, atol=1e-7)
