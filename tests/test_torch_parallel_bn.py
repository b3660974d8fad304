"""The data-parallel building blocks of the port's nine other trainers, at
world size N (``gloo`` ranks on the CPU, spawned once a size by
``torch_parallel_ranks``), against flax and the JAX package.

* ``models.resnet.BatchNorm`` under a process group: the output, the input's,
  scale's and bias's gradients (after the gradient all-reduce) and the
  running statistics of a train-mode step at world 2 and 3, with unequal
  shards (7 rows: 4 + 3 and 3 + 2 + 2) and with a rank without rows (1 row
  at world 2, 2 rows at world 3), against flax's ``nn.BatchNorm`` on the
  global batch; eval mode makes no collective, train mode one all-reduce
  forward and one backward; a group of one rank bit-equal to no group.
* ``parallel.gather_batch``: the global rows in the global order (two blocks
  of rows, as ``[rgb_r; ir_r]``), its backward this rank's slice of the
  incoming gradient with nothing summed, and ``local_rows`` its inverse.
* ``parallel.fsdp_shard`` over ``make_mesh(shape=(world, 1))``: two Adam
  steps with the large weights sharded equal the replicated steps, and each
  rank holds 1/N of every large leaf and of its Adam moments.

Tolerances: the output and the running statistics rtol 1e-5 / atol 1e-6, the
gradients rtol 1e-4 / atol 1e-6 against flax (fp32 sums in another order, as
``tests/test_torch_resnet.py`` holds the module); every rank's scale and bias
gradients and statistics bit-equal to rank 0's; the sharded steps' parameters
bit-equal to the replicated steps' (Adam is elementwise).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from vqvae2_tpu_torch import parallel as par

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
C = 5


def bn_case(rows, seed=0):
    g = np.random.default_rng(seed)
    x = (g.normal(size=(rows, 3, 2, C)) * 2 + 1).astype(np.float32)
    dy = g.normal(size=x.shape).astype(np.float32)
    scale = (1 + 0.2 * g.normal(size=C)).astype(np.float32)
    bias = (0.1 * g.normal(size=C)).astype(np.float32)
    return x, dy, scale, bias


def empty_rank_rows(world):
    return world - 1            # the last rank gets no row


def fsdp_case():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 48), torch.nn.Tanh(), torch.nn.Linear(48, 96),
                                torch.nn.Tanh(), torch.nn.Linear(96, 3))
    x = np.random.default_rng(4).normal(size=(2, 12, 16)).astype(np.float32)
    return model.state_dict(), x


FSDP_MIN = 700                  # the 48x16 and 96x48 weights (768, 4608) shard


def jobs():
    sd, x = fsdp_case()
    return [("sync_bn", bn_case(7)), ("gather_backward", (5, 2, gather_weights(5, 2))),
            ("fsdp_steps", (sd, x, FSDP_MIN, True)), ("fsdp_steps", (sd, x, FSDP_MIN, False))]


def gather_weights(rows, groups):
    return np.random.default_rng(9).normal(size=(groups * rows, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return ranks.run_worlds(
        (2, 3), tmp_path_factory,
        lambda n: jobs() + [("sync_bn", bn_case(empty_rank_rows(n), seed=1))])


@pytest.fixture(scope="module", params=[2, 3])
def world(request, worlds):
    return request.param, worlds[request.param]


def flax_bn(x, dy, scale, bias):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def fwd(x, params):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])

    y, stats = fwd(jnp.asarray(x), params)
    _, pull = jax.vjp(lambda x, p: fwd(x, p)[0], jnp.asarray(x), params)
    dx, dp = pull(jnp.asarray(dy))
    st = stats["batch_stats"]
    return {"y": np.asarray(y), "dx": np.asarray(dx), "dscale": np.asarray(dp["scale"]),
            "dbias": np.asarray(dp["bias"]), "running_mean": np.asarray(st["mean"]),
            "running_var": np.asarray(st["var"])}


def check_bn(results, case):
    want = flax_bn(*case)
    y = torch.cat([r["y"] for r in results]).numpy()
    dx = torch.cat([r["dx"] for r in results]).numpy()
    np.testing.assert_allclose(y, want["y"], **TOL)
    np.testing.assert_allclose(dx, want["dx"], **GRAD_TOL)
    for r in results:
        np.testing.assert_allclose(r["dscale"].numpy(), want["dscale"], **GRAD_TOL)
        np.testing.assert_allclose(r["dbias"].numpy(), want["dbias"], **GRAD_TOL)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[k].numpy(), want[k], **TOL)
        for k in ("dscale", "dbias", "running_mean", "running_var"):
            assert torch.equal(r[k], results[0][k]), k
        # one all-reduce forward and one backward; none in eval mode
        assert (r["train_collectives"], r["eval_collectives"]) == (2, 0)


def test_sync_bn_is_flax_on_the_global_batch(world):
    n, out = world
    results = [res[0] for res in out]
    assert [r["y"].shape[0] for r in results] == ([4, 3] if n == 2 else [3, 2, 2])
    check_bn(results, bn_case(7))


def test_sync_bn_with_a_rank_without_rows(world):
    n, out = world
    results = [res[-1] for res in out]
    assert results[-1]["y"].shape[0] == 0
    check_bn(results, bn_case(empty_rank_rows(n), seed=1))


def test_eval_mode_uses_the_running_statistics(world):
    """Eval mode normalises each rank's rows by the buffers, which the
    train step left equal on every rank."""
    n, out = world
    x, _, scale, bias = bn_case(7)
    r0 = out[0][0]
    want = ((x - r0["running_mean"].numpy()) / np.sqrt(r0["running_var"].numpy() + 1e-5)
            * scale + bias)
    got = torch.cat([res[0]["y_eval"] for res in out]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_a_world_of_one_is_bit_equal_to_no_group(tmp_path):
    case = bn_case(7)
    alone = ranks.sync_bn(0, 1, *case)
    par.init_distributed("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        grouped = ranks.sync_bn(0, 1, *case)
        g_alone = ranks.gather_backward(0, 1, 5, 2, gather_weights(5, 2))
    finally:
        dist.destroy_process_group()
    for k in ("y", "dx", "dscale", "dbias", "running_mean", "running_var", "y_eval"):
        assert torch.equal(grouped[k], alone[k]), k
    assert (alone["train_collectives"], grouped["train_collectives"]) == (0, 2)
    no_group = ranks.gather_backward(0, 1, 5, 2, gather_weights(5, 2))
    for k in ("gathered", "grad", "local"):
        assert torch.equal(g_alone[k], no_group[k]), k


def test_gather_batch_orders_the_blocks_and_slices_the_gradient(world):
    """Two blocks of rows (block g holds ``100 g + row``): the gathered
    tensor is block 0 of every rank, then block 1; each rank's gradient is
    its own rows of the weights, nothing summed over the ranks."""
    n, out = world
    rows, groups = 5, 2
    weights = gather_weights(rows, groups)
    want = np.concatenate([np.arange(rows) + 100 * g for g in range(groups)]).astype(np.float32)
    for r, res in enumerate(out):
        got = res[1]
        np.testing.assert_array_equal(got["gathered"].numpy(), np.stack([want, want], 1))
        start, stop = par.shard_rows(rows, par.Mesh(n, r, torch.device("cpu")))
        own = np.concatenate([weights[g * rows + start:g * rows + stop] for g in range(groups)])
        np.testing.assert_array_equal(got["grad"].numpy(), own)
        np.testing.assert_array_equal(got["local"].numpy(),
                                      np.concatenate([want[g * rows + start:g * rows + stop]
                                                      for g in range(groups)])[:, None]
                                      .repeat(2, 1))


def test_fsdp_step_is_the_replicated_step(world):
    n, out = world
    for res in out:
        sharded, replicated = res[2], res[3]
        assert sharded["mesh"] == {par.DATA_AXIS: n, par.MODEL_AXIS: 1}
        assert sharded["losses"] == replicated["losses"]
        for k, v in replicated["state"].items():
            assert torch.equal(sharded["state"][k], v), k
            assert torch.equal(v, out[0][3]["state"][k]), k


def test_fsdp_holds_a_shard_of_each_large_leaf_and_its_moments(world):
    n, out = world
    sd, _ = fsdp_case()
    for res in out:
        held = res[2]["held"]
        for name, t in sd.items():
            shard, moment = held[name]
            assert shard == moment
            if t.numel() >= FSDP_MIN:
                assert np.prod(shard) * n == t.numel(), name
                assert max(t.shape) // n in shard, name
            else:
                assert shard == tuple(t.shape), name


def test_make_mesh_takes_a_model_axis_of_one():
    mesh = par.make_mesh("cpu", (par.DATA_AXIS, par.MODEL_AXIS), shape=(1, 1))
    assert mesh.shape == {par.DATA_AXIS: 1, par.MODEL_AXIS: 1}
    assert par.make_mesh("cpu", (par.DATA_AXIS, par.MODEL_AXIS)).shape[par.MODEL_AXIS] == 1
    with pytest.raises(ValueError, match="model"):
        par.make_mesh("cpu", (par.DATA_AXIS, par.MODEL_AXIS), shape=(1, 2))
    with pytest.raises(ValueError, match="axes"):
        par.make_mesh("cpu", ("model",))
    shards = par.fsdp_shard({"w": torch.zeros(4, 4)}, min_size=1)
    assert not shards.spans                               # one rank: nothing to split
