"""The port's ``parallel`` layer (``vqvae2_tpu_torch/parallel``) against the
JAX package's ``vqvae2_tpu/parallel`` and its sharded kernels' rules, on the
CPU: the API without a group; the split of a batch over the ranks, its
once-per-shape warning and ``strict``; ``data_sampler`` and ``reduce_dict``
against JAX's; the attention seed's offset a rank against
``_shard_seed_offset`` on the 8 virtual devices; no launch for a rank with no
rows; and, in ``gloo`` worlds of spawned processes (``torch_parallel_ranks``),
the collectives and the synchronised in-place ABN at world 2 and 3 against
the JAX package's ``shard_map`` path, its op on the global batch and the
port's own module in one process.

Tolerances: the ABN's forward 1e-5 and its gradients rtol 2e-4 / atol 2e-5,
as ``tests/test_torch_inplace_abn.py`` holds the op to JAX (the moments and
sums are added over the ranks in another order); every rank's weight
gradient, bias gradient and running statistics bit-equal to rank 0's.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from vqvae2_tpu import parallel as jpar
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.models.abn import InPlaceABN, InPlaceABNSync
from vqvae2_tpu_torch.ops import flash_attention as fa
from vqvae2_tpu_torch.ops import inplace_abn as ia
from vqvae2_tpu_torch.ops import quantize as qz

# the JAX package's ops/__init__ re-exports functions under the modules' names
jabn = importlib.import_module("vqvae2_tpu.ops.inplace_abn")
jfa = importlib.import_module("vqvae2_tpu.ops.flash_attention")

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def test_without_a_group_every_query_and_collective_is_the_identity():
    assert not par.is_initialized()
    assert (par.get_rank(), par.get_world_size(), par.get_local_rank()) == (0, 1, 0)
    assert par.is_primary()
    par.synchronize()
    x = torch.arange(12.0).reshape(4, 3)
    assert par.all_reduce(x) is x and par.pmean(x) is x and par.gather_rows(x, 4) is x
    assert torch.equal(par.all_gather(x), x[None])
    assert par.row_offset(4, "cpu") == (0, 4)
    index = torch.tensor([3, 0, 0])
    assert torch.equal(par.take_rows(x, index, 0), x[index])
    module = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    module(x).sum().backward()
    grads = [p.grad.clone() for p in module.parameters()]
    assert par.replicate(module) is module
    par.all_reduce_grads(module.parameters())
    assert all(torch.equal(v, before[k]) for k, v in module.state_dict().items())
    assert all(torch.equal(p.grad, g) for p, g in zip(module.parameters(), grads))
    out = par.shard_batch({"x": x, "n": 3})
    assert torch.equal(out["x"], x) and out["n"] == 3


@pytest.mark.parametrize("average", [True, False])
def test_reduce_dict_is_jaxs_without_a_group(average):
    d = {"loss": np.float32(0.3125), "acc": np.array([0.25, 0.5, 1.0], np.float32)}
    want = jpar.reduce_dict({k: jnp.asarray(v) for k, v in d.items()}, average=average)
    got = par.reduce_dict({k: torch.from_numpy(np.asarray(v)) for k, v in d.items()},
                          average=average)
    assert got == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("rows,world", [(8, 2), (8, 3), (1, 3), (0, 2), (7, 4), (9, 1)])
def test_shard_rows_are_contiguous_in_rank_order(rows, world):
    spans = [par.shard_rows(rows, par.Mesh(world, r, torch.device("cpu")))
             for r in range(world)]
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [stop - start for start, stop in spans]
    assert sizes == sorted(sizes, reverse=True) and sizes[0] - sizes[-1] <= 1


def test_shard_batch_warns_once_per_shape_and_strict_raises():
    """The behaviour ``tests/test_utils.py::test_shard_batch_indivisible_guard``
    pins in JAX, with unequal shards where JAX replicates."""
    world = 2
    meshes = [par.Mesh(world, r, torch.device("cpu")) for r in range(world)]
    x = np.arange(5 * 4, dtype=np.float32).reshape(5, 4)
    par._INDIVISIBLE_WARNED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shards = [par.shard_batch(x, m) for m in meshes]
        assert sum("not divisible" in str(w.message) for w in caught) == 1
    np.testing.assert_array_equal(np.concatenate(shards), x)     # every row once
    assert [len(s) for s in shards] == [3, 2]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        par.shard_batch(x, meshes[0])
        assert not any("not divisible" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="not divisible"):
        par.shard_batch(x, meshes[0], strict=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = par.shard_batch({"x": torch.from_numpy(x[:4]), "t": 7}, meshes[1], strict=True)
        assert not any("not divisible" in str(w.message) for w in caught)
    assert torch.equal(out["x"], torch.from_numpy(x[2:4])) and out["t"] == 7


def test_shard_microbatches_splits_the_rows_of_each_microbatch():
    meshes = [par.Mesh(2, r, torch.device("cpu")) for r in range(2)]
    x = np.arange(3 * 4 * 2, dtype=np.float32).reshape(3, 4, 2)
    parts = [par.shard_microbatches(x, m) for m in meshes]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), x)
    assert parts[0].shape == (3, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        par.shard_microbatches(x[:, :3], meshes[0])


@pytest.mark.parametrize("n,shuffle,seed", [(10, True, 0), (37, True, 5), (8, False, 3)])
def test_data_sampler_is_jaxs(n, shuffle, seed):
    np.testing.assert_array_equal(par.data_sampler(n, shuffle, seed),
                                  jpar.data_sampler(n, shuffle, seed))


def test_make_mesh_describes_the_world():
    mesh = par.make_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
    assert mesh.shape == {par.DATA_AXIS: 1}
    assert par.make_mesh("cpu", axis_names=(par.DATA_AXIS, par.MODEL_AXIS)).shape == {
        par.DATA_AXIS: 1, par.MODEL_AXIS: 1}
    with pytest.raises(ValueError, match="axis"):
        par.make_mesh("cpu", axis_names=(par.DATA_AXIS, par.MODEL_AXIS), shape=(1, 2))
    with pytest.raises(ValueError, match="axis"):
        InPlaceABN(4, axis_name=par.MODEL_AXIS)
    assert InPlaceABNSync(4).axis_name == par.DATA_AXIS


def test_attention_seed_offset_is_the_jax_shard_rule(devices):
    """Shard ``r`` of the JAX package's sharded attention adds
    ``_shard_seed_offset`` to its int32 seed; the port's rank ``r`` adds the
    same number modulo 2**32 (its seed is 64 bits wide), rank 0 nothing."""
    mesh = JaxMesh(np.asarray(devices), ("data",))
    offsets = shard_map(lambda s: s + jfa._shard_seed_offset("data"), mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"))(jnp.zeros(8, jnp.int32))
    want = np.asarray(offsets).view(np.uint32)
    got = [fa.shard_seed_offset(r) % 2 ** 32 for r in range(len(devices))]
    assert got == list(want) and got[0] == 0
    assert len({fa.shard_seed_offset(r) for r in range(1 << 12)}) == 1 << 12


def test_no_rows_launch_nothing():
    """A rank's empty share of a short batch: no kernel, no plain version;
    empty ids, zero statistics; the ABN passes keep their shapes."""
    qz.reset_counts()
    ia.reset_counts()
    embed = torch.randn(5, 4)
    idx, q, csum, esum = qz.nearest_code(torch.zeros(0, 4), embed, with_stats=True)
    assert idx.shape == (0,) and q.shape == (0, 4) and idx.dtype == torch.int32
    assert torch.equal(csum, torch.zeros(5)) and torch.equal(esum, torch.zeros(5, 4))
    assert qz.nearest_code_ids(torch.zeros(0, 4), embed).shape == (0,)
    v = torch.ones(3)
    z = ia.abn_forward(torch.zeros(0, 3), v, v, v)
    dx, edz, eydz = ia.abn_backward(z, z, v, v, v, 0.25)
    assert z.shape == dx.shape == (0, 3) and torch.equal(edz, torch.zeros(3))
    assert sum(qz.plain_counts.values()) == sum(qz.launch_counts.values()) == 0
    assert sum(ia.plain_counts.values()) == sum(ia.launch_counts.values()) == 0


def test_collectives_in_a_world_of_two(tmp_path):
    world = 2
    results = ranks.run_world(world, tmp_path, [("collectives", ()),
                                                ("attention_seed", (11,))])
    seed_1 = ranks.attention_seed(0, 1, 11)                 # no group: the world-1 draw
    rows = 2 * world + 1
    for r, (c, seed) in enumerate(results):
        assert (c["rank"], c["world"], c["local_rank"], c["primary"]) == (r, world, r, r == 0)
        x = [torch.arange(6.0).reshape(2, 3) + 10 * k for k in range(world)]
        assert torch.equal(c["all_reduce"], sum(x)) and torch.equal(c["x_after"], x[r])
        assert torch.equal(c["all_gather"], torch.stack(x))
        assert torch.equal(c["pmean"], sum(x) / world)
        assert c["reduce_dict"] == {"loss": 1.5, "n": 1.25}
        assert c["reduce_dict_sum"] == {"loss": 3.0}
        assert torch.equal(c["replicated"], torch.ones(2, 3))
        assert torch.equal(c["tree"]["a"], torch.zeros(2))
        assert torch.equal(c["tree"]["b"][0], torch.full((1,), 5.0))
        all_rows = torch.arange(rows, dtype=torch.float32)[:, None] * torch.ones(1, 2)
        assert torch.equal(c["gather_rows"], all_rows)
        assert (c["offset"], c["total"]) == ((0, 3)[r], rows)
        assert torch.equal(c["take_rows"], all_rows[torch.tensor([0, rows - 1, 1, 2 * world])])
        assert c["mesh"].world_size == world and c["mesh"].rank == r
        assert seed == (seed_1 + fa.shard_seed_offset(r)) % 2 ** 64
    assert results[0][1] == seed_1 != results[1][1]


def _abn_case(rows=16, c=8):
    g = np.random.default_rng(3)
    x = g.normal(size=(rows, 3, 3, c)).astype(np.float32)
    dz = g.normal(scale=1.0 / x.size, size=x.shape).astype(np.float32)
    w = (g.normal(size=c) + 1.0).astype(np.float32)
    w[1] = -w[1]                                              # the sign flip of dweight
    b = g.normal(size=c).astype(np.float32)
    return x, dz, w, b


def _jax_abn(x, dz, w, b, world, devices):
    """JAX's ABN op: under ``shard_map`` over ``world`` devices with
    ``axis_name="data"`` when the rows divide, else on the global batch."""
    def local(x, w, b):
        mean, var = jabn.batch_moments(x, axis_name="data")
        return jabn.inplace_abn(x, w, b, mean, var, 1e-5, jabn.ACT_LEAKY_RELU, 0.01, "data",
                                True)

    def whole(x, w, b):
        mean, var = jabn.batch_moments(x)
        return jabn.inplace_abn(x, w, b, mean, var, 1e-5, jabn.ACT_LEAKY_RELU, 0.01, None,
                                True)

    fn = whole
    if x.shape[0] % world == 0:
        mesh = JaxMesh(np.asarray(devices[:world]), ("data",))
        fn = shard_map(local, mesh=mesh, in_specs=(P("data"), P(), P()), out_specs=P("data"))
    z, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(t) for t in (z, *vjp(jnp.asarray(dz)))]


def _port_abn_one_process(x, dz, w, b):
    abn = InPlaceABN(x.shape[-1])
    with torch.no_grad():
        abn.weight.copy_(torch.from_numpy(w))
        abn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    z = abn(xt)
    z.backward(torch.from_numpy(dz))
    return {"z": z.detach(), "dx": xt.grad, "dweight": abn.weight.grad,
            "dbias": abn.bias.grad, "running_mean": abn.running_mean,
            "running_var": abn.running_var}


@pytest.mark.parametrize("world", [2, 3])
def test_sync_abn_at_world_n(world, tmp_path, devices):
    """Forward, dx, dweight and dbias of ``InPlaceABNSync`` at world N (16
    rows: 8 + 8, and 6 + 5 + 5) against JAX's ``shard_map`` path (world 2) or
    its op on the global batch (world 3, whose shards do not divide), and
    against the port's module in one process; the weight gradient is the
    single-process one after the gradient all-reduce, not N times it."""
    x, dz, w, b = _abn_case()
    results = [r[0] for r in ranks.run_world(world, tmp_path, [("sync_abn", (x, dz, w, b))])]
    one = _port_abn_one_process(x, dz, w, b)
    jz, jdx, jdw, jdb = _jax_abn(x, dz, w, b, world, devices)
    z = torch.cat([r["z"] for r in results])
    dx = torch.cat([r["dx"] for r in results])
    np.testing.assert_allclose(z.numpy(), one["z"].numpy(), **TOL)
    np.testing.assert_allclose(z.numpy(), jz, **TOL)
    np.testing.assert_allclose(dx.numpy(), one["dx"].numpy(), **GRAD_TOL)
    np.testing.assert_allclose(dx.numpy(), jdx, **GRAD_TOL)
    for r in results:
        np.testing.assert_allclose(r["dweight"].numpy(), one["dweight"].numpy(), **GRAD_TOL)
        np.testing.assert_allclose(r["dweight"].numpy(), jdw, **GRAD_TOL)
        np.testing.assert_allclose(r["dbias"].numpy(), one["dbias"].numpy(), **GRAD_TOL)
        np.testing.assert_allclose(r["dbias"].numpy(), jdb, **GRAD_TOL)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[k].numpy(), one[k].numpy(), **TOL)
        for k in ("dweight", "dbias", "running_mean", "running_var", "mean", "var"):
            assert torch.equal(r[k], results[0][k]), k
    # each rank's own sums are a part of the whole: their sum is the gradient
    own = sum(r["own"]["dweight"] for r in results)
    np.testing.assert_allclose(own.numpy(), results[0]["dweight"].numpy(), rtol=1e-6, atol=1e-9)
    assert not torch.allclose(results[0]["own"]["dweight"], results[0]["dweight"])
