"""The pipeline's trainers at world size N (``gloo`` on the CPU) against the
same step in one process and against the JAX package's step on a batch that
``vqvae2_tpu.parallel.shard_batch`` lays over its 8 virtual devices.

One world a size (2 and 3 ranks, spawned once per module by
``torch_parallel_ranks``) runs, from the same seeded weights and the same
global batches: a ``train.vqvae`` step of a toy VQ-VAE with dead-code restart
(8 images: 4 + 4 and 3 + 3 + 2 rows), and one of two microbatches; a step of a toy top prior at dropout 0 and of a toy bottom
prior, whose conditioning blocks drop at 0.1 whatever ``--dropout`` says;
``extract_codes.extract`` of 9 images in batches of 4, so that the last batch
of one image leaves ranks with no rows.  A world of one, a ``gloo`` group in
this process, must give the run without a group bit for bit, and so must
``launch`` under a ``torchrun`` environment of one rank.

Tolerances:
- gradients: each tensor within GRAD_RTOL = 1e-5 of its largest element of
  the one-process step (the ranks' shares are summed in another order), and
  within JAX_GRAD_RTOL = 1e-4 of the JAX step's (fp32 convolutions in another
  order), with a floor of a thousandth of the whole gradient's largest
  element; compared before Adam: Adam's first step is ``lr * sign(g)``, which
  a near-zero gradient summed in another order can flip;
- the quantizers' counts ``csum`` exact; their sums ``esum`` within ESUM_RTOL
  = 1e-5 of a float64 sum of the same rows, per element, of its terms'
  magnitude; their rows bit-equal to the one-process rows;
- the codebooks after the EMA step and restart: rtol 1e-5 / atol 1e-7 of the
  one-process step, rtol 1e-4 / atol 1e-5 of the JAX step's
  (``tests/test_torch_train_vqvae.py``'s tolerance);
- every rank's parameters, buffers and optimizer moments bit-equal to rank 0's;
- the code store of N ranks byte for byte the store of one process.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from vqvae2_tpu import parallel as jpar
from vqvae2_tpu.models.vqvae import VQVAE as JaxVQVAE
from vqvae2_tpu.train import pixelsnail as jtp
from vqvae2_tpu.train import vqvae as jtv
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.train import pixelsnail as tp
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.utils.jax_import import pixelsnail_from_jax, vqvae_from_jax

GRAD_RTOL, JAX_GRAD_RTOL, ESUM_RTOL = 1e-5, 1e-4, 1e-5
CB_TOL, JAX_CB_TOL = dict(rtol=1e-5, atol=1e-7), dict(rtol=1e-4, atol=1e-5)
LR = 3e-4
# 48 codes over 32 top rows: the restart's rows arange(48) % 32 span every image
CFG = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=48,
           restart_threshold=0.5)
SIZE, BATCH = 16, 8
CODE_HW, N_CLASS = (8, 16), 16
EXTRACT = dict(n_images=9, size=SIZE, batch=4)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def vqvae_start():
    jmodel = JaxVQVAE(**CFG)
    variables = host(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    g = np.random.default_rng(0)
    for q in ("quantize_t", "quantize_b"):
        embed = (0.05 * g.normal(size=(48, 8))).astype(np.float32)
        variables["vq_stats"][q] = {"embed": embed, "embed_avg": embed.copy(),
                                    "cluster_size": g.uniform(size=48).astype(np.float32)}
    return jmodel, variables


def images(shape=(BATCH, SIZE, SIZE, 3), seed=1):
    return np.random.default_rng(seed).normal(scale=0.5, size=shape).astype(np.float32)


def prior_args(dropout=0.0):
    return argparse.Namespace(n_class=N_CLASS, channel=32, n_res_block=1, n_res_channel=32,
                              n_out_res_block=0, n_cond_res_block=1, dropout=dropout,
                              bf16=False)


def prior_batch(hier, seed=0):
    g = np.random.default_rng(seed)
    top = g.integers(0, N_CLASS, size=(BATCH, 8, 8)).astype(np.int64)
    if hier == "top":
        return {"target": top}
    return {"target": g.integers(0, N_CLASS, size=(BATCH, 16, 16)).astype(np.int64),
            "condition": top}


@functools.lru_cache(maxsize=None)
def prior_start(hier):
    jmodel = jtp.build_model(hier, prior_args(), code_hw=CODE_HW)
    batch = prior_batch(hier)
    cond = jnp.asarray(batch["condition"][:1]) if hier == "bottom" else None
    params = host(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["target"][:1]),
                              condition=cond)["params"])
    with torch.random.fork_rng(devices=[]):
        model = tp.build_model(hier, prior_args(), code_hw=CODE_HW)
    return jmodel, params, pixelsnail_from_jax({"params": params}, model)


def jobs(world, store):
    sd = vqvae_from_jax(vqvae_start()[1])
    out = [("stage1_step", (sd, CFG, images(), LR)),
           ("prior_step", ("top", prior_start("top")[2], prior_args(), CODE_HW,
                           prior_batch("top"), 1)),
           ("prior_step", ("bottom", prior_start("bottom")[2], prior_args(), CODE_HW,
                           prior_batch("bottom"), 1)),
           ("extract_store", (sd, CFG, *EXTRACT.values(), store)),
           ("stage1_step", (sd, CFG, microbatches(world), LR, 2))]
    return out


def microbatches(world):
    """Two microbatches of ``2 * world`` images: their rows divide over the
    ranks, as ``shard_microbatches`` asks."""
    return images((2, 2 * world, SIZE, SIZE, 3), seed=2)


def one_process(store):
    """The same jobs without a process group."""
    return [getattr(ranks, name)(0, 1, *args) for name, args in jobs(1, store)]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("one") / "codes.vq2")
    return one_process(store), store


@pytest.fixture(scope="module", params=[2, 3])
def world(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"world{n}")
    store = str(tmp / "codes.vq2")
    return n, ranks.run_world(n, tmp, jobs(n, store)), store


def assert_grads_close(got, want, rtol, what):
    """Each tensor within ``rtol`` of its largest element, with a floor of a
    thousandth of the whole gradient's largest (for a gradient that vanishes
    analytically, as the attention key's bias does under the softmax)."""
    assert set(got) == set(want)
    floor = 1e-3 * max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, g in got.items():
        w = np.asarray(want[name])
        err = float(np.abs(g.numpy() - w).max())
        assert err <= rtol * max(float(np.abs(w).max()), floor), f"{what}: {name} off by {err}"


def jax_stage1():
    """The JAX step's gradients and state after it, on the batch sharded over
    the 8 virtual devices."""
    jmodel, variables = vqvae_start()
    mesh = jpar.make_mesh(jax.devices())
    xs = jpar.shard_batch(images(), mesh)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["vq_stats"])

    def loss(p):
        (dec, diff), _ = jmodel.apply({"params": p, "vq_stats": stats}, xs, train=True,
                                      mutable=["vq_stats"])
        return jnp.mean(jnp.square(dec - xs)) + jtv.LATENT_LOSS_WEIGHT * diff

    grads = vqvae_from_jax({"params": host(jax.jit(jax.grad(loss))(params))})
    tx = optax.adam(LR)
    state = jpar.replicate(jtv.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                          vq_stats=stats, opt_state=tx.init(params)), mesh)
    state, _ = jtv.make_train_step(jmodel, tx)(state, xs)
    return grads, vqvae_from_jax(host({"params": state.params, "vq_stats": state.vq_stats}))


@functools.lru_cache(maxsize=None)
def jax_stage1_cached():
    return jax_stage1()


def codebooks(state):
    return {k: v for k, v in state.items() if k.split(".")[-1] in
            ("embed", "embed_avg", "cluster_size")}


def test_stage1_gradients_are_the_single_process_ones(world, single):
    n, results, _ = world
    want = single[0][0]["grads"]
    jax_grads = jax_stage1_cached()[0]
    for r, res in enumerate(results):
        assert_grads_close(res[0]["grads"], want, GRAD_RTOL, f"world {n} rank {r}")
        assert_grads_close(res[0]["grads"], jax_grads, JAX_GRAD_RTOL, f"world {n} vs JAX")


def test_stage1_statistics_are_the_global_batchs(world, single):
    """``csum`` exact, ``esum`` within ESUM_RTOL of float64, both the global
    batch's on every rank; the ranks' rows are the one-process rows."""
    n, results, _ = world
    one = single[0][0]["ema"]
    for r, res in enumerate(results):
        for i, rec in enumerate(res[0]["ema"]):
            ref = one[i]
            assert rec["name"] == ref["name"]
            assert torch.equal(rec["csum"], ref["csum"]), f"rank {r} {rec['name']}"
            rows = torch.cat([results[k][0]["ema"][i]["flat"] for k in range(n)])
            assert torch.equal(rows, ref["flat"])
            ids = torch.argmax(2 * rows @ ref["embed"].T - (ref["embed"] ** 2).sum(1), 1)
            assert torch.equal(torch.bincount(ids, minlength=48).float(), rec["csum"])
            f64 = torch.zeros(48, 8, dtype=torch.float64).index_add_(0, ids, rows.double())
            mag = torch.zeros(48, 8, dtype=torch.float64).index_add_(0, ids, rows.double().abs())
            assert bool(((rec["esum"].double() - f64).abs() <= ESUM_RTOL * mag + 1e-30).all())


def test_stage1_codebook_after_the_ema_step_and_restart(world, single):
    n, results, _ = world
    want = codebooks(single[0][0]["state"])
    jax_state = codebooks(jax_stage1_cached()[1])
    dead = [k for k in want if k.endswith("cluster_size") and bool((want[k] == 1.0).any())]
    assert dead, "the restart did not fire: no code has a cluster size of 1 after the step"
    for res in results:
        got = codebooks(res[0]["state"])
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **CB_TOL, err_msg=k)
            np.testing.assert_allclose(got[k].numpy(), jax_state[k].numpy(), **JAX_CB_TOL,
                                       err_msg=k)


def test_every_rank_holds_rank_0s_state(world):
    """Parameters, codebooks and gradients (what Adam's moments are made of)
    of every step, bit for bit."""
    n, results, _ = world
    steps = [j for j, out in enumerate(results[0]) if isinstance(out, dict)]
    assert steps == [0, 1, 2, 4]
    for job in steps:
        for res in results[1:]:
            for part in ("state", "grads"):
                for k, v in results[0][job][part].items():
                    assert torch.equal(res[job][part][k], v), (job, part, k)


def test_stage1_microbatches_at_world_n(world):
    """``--grad_accum 2``: each microbatch's rows split over the ranks, an
    EMA step each, one update from the averaged gradients."""
    n, results, _ = world
    sd = vqvae_from_jax(vqvae_start()[1])
    want = ranks.stage1_step(0, 1, sd, CFG, microbatches(n), LR, 2)
    for res in results:
        assert_grads_close(res[4]["grads"], want["grads"], GRAD_RTOL, "grad_accum=2")
        for k, v in codebooks(want["state"]).items():
            np.testing.assert_allclose(res[4]["state"][k].numpy(), v.numpy(), **CB_TOL)


def jax_prior_grads(hier):
    jmodel, params, _ = prior_start(hier)
    batch = jpar.shard_batch({k: v.astype(np.int32) for k, v in prior_batch(hier).items()},
                             jpar.make_mesh(jax.devices()))

    def loss(p):
        logits = jmodel.apply({"params": p}, batch["target"],
                              condition=batch.get("condition"), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), batch["target"]).mean()

    grads = host(jax.jit(jax.grad(loss))(jax.tree_util.tree_map(jnp.asarray, params)))
    with torch.random.fork_rng(devices=[]):
        model = tp.build_model(hier, prior_args(), code_hw=CODE_HW)
    return pixelsnail_from_jax({"params": grads}, model)


def test_top_prior_step_is_the_single_process_one(world, single):
    """Dropout 0: the same gradients as one process and as the JAX step."""
    n, results, _ = world
    want = single[0][1]["grads"]
    jax_grads = {k: v for k, v in jax_prior_grads("top").items() if k in want}
    for res in results:
        assert_grads_close(res[1]["grads"], want, GRAD_RTOL, f"top prior, world {n}")
        assert_grads_close({k: res[1]["grads"][k] for k in jax_grads}, jax_grads,
                           JAX_GRAD_RTOL, f"top prior, world {n} vs JAX")


def test_bottom_prior_drops_the_global_batchs_rows(world, single):
    """The conditioning blocks drop at 0.1: each rank draws the global
    batch's masks and keeps its rows, so the step is one process's."""
    n, results, _ = world
    for res in results:
        assert_grads_close(res[2]["grads"], single[0][2]["grads"], GRAD_RTOL,
                           f"bottom prior, world {n}")


def test_extraction_store_is_byte_for_byte_one_process(world, single):
    n, results, store = world
    assert all(res[3] == EXTRACT["n_images"] for res in results)
    with open(store, "rb") as a, open(single[1], "rb") as b:
        assert a.read() == b.read()


def test_a_world_of_one_is_bit_equal_to_no_group(tmp_path, single):
    """The collectives run in a group of one rank: the result is the run
    without a group's, bit for bit."""
    store = str(tmp_path / "codes.vq2")
    par.init_distributed("file://" + str(tmp_path / "store"), 1, 0, device="cpu")
    try:
        got = [getattr(ranks, name)(0, 1, *args) for name, args in jobs(1, store)]
    finally:
        dist.destroy_process_group()
    want = single[0]
    for job in (0, 1, 2, 4):
        for part in ("grads", "state"):
            for k, v in want[job][part].items():
                assert torch.equal(got[job][part][k], v), (job, part, k)
    for a, b in zip(got[0]["ema"], want[0]["ema"]):
        assert all(torch.equal(a[k], b[k]) for k in ("flat", "csum", "esum"))
    with open(store, "rb") as a, open(single[1], "rb") as b:
        assert a.read() == b.read()


def test_launch_forms_a_torchrun_world_of_one(tmp_path, monkeypatch):
    """``train.vqvae.main`` through ``launch`` under a ``torchrun``
    environment of one rank (``gloo`` for ``--device cpu``) writes the
    checkpoint of a run without one, and leaves no group behind."""
    import socket

    argv = ["--synthetic", "--steps", "2", "--size", "16", "--batch_size", "4",
            "--channel", "16", "--n_res_block", "1", "--n_res_channel", "8", "--embed_dim", "8",
            "--n_embed", "16", "--workers", "0", "--log_every", "1", "--device", "cpu"]
    tv.main(argv + ["--ckpt_dir", str(tmp_path / "alone")])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(tv, "train", lambda args, f=tv.train: seen.append(
        (par.is_initialized(), dist.get_backend())) or f(args))
    tv.main(argv + ["--ckpt_dir", str(tmp_path / "world")])
    assert seen == [(True, "gloo")] and not par.is_initialized()
    a = torch.load(tmp_path / "alone" / "last.pt", weights_only=True)
    b = torch.load(tmp_path / "world" / "last.pt", weights_only=True)
    for k, v in a["model"].items():
        assert torch.equal(b["model"][k], v), k
    assert a["step"] == b["step"] == 2
