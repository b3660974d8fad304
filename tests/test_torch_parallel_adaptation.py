"""The six adaptation and StarGAN trainers at world size N (``gloo`` ranks on
the CPU, spawned once a size by ``torch_parallel_ranks``) against the same
step in one process and against the JAX package's step on a batch that
``vqvae2_tpu.parallel.shard_batch`` lays over its 8 virtual devices.

One step of each of ``train.adaptive``, ``train.gray2color``,
``train.vqvae_deep``, ``train.vqvae_deep_bi``, ``train.vqvae_deep_ir`` (its
full step) and ``train.stargan_bi``, from the seeded weights of each
trainer's own test file at its widths (resnet18, four identities,
``VQVAE_Deep`` narrowed to channel 16, ``style_dim`` 16, StarGAN's hourglass
16 wide), on P = 2 identities of K = 4 images (8 rows: 4 + 4 and 3 + 3 + 2):
64x32 images, 64x64 for StarGAN.  The deep trainer's ``roll(arange(B), K)``
pairs each of a rank's rows with a row of another rank.  Its gray mix is
pinned to one set of numpy weights on both sides, as in
``tests/test_torch_train_vqvae_deep.py``.  Then ``train.vqvae_deep.main`` at
world 2 with a validation, a sample grid and checkpoints, which run on the
primary rank alone and in eval mode, and end.

Tolerances:
- against the JAX step, those of each trainer's own file: the metrics rtol
  1e-4 / atol 1e-5 (gray2color's 1e-3, measured 1.2e-4 there; the gray ->
  IR trainer's generator metrics 5e-4; StarGAN's metrics after the ReID
  update 2e-2); statistics and codebooks within 1e-4 of their largest
  element (the gray -> IR trainer's 1e-3); each optimizer's gradient as
  one vector within the tolerance that file holds it to (1e-2 of its norm;
  3e-2 for gray2color, the bi trainer's SGD, the gray -> IR trainer's two
  and StarGAN's SGD; 3e-1 for StarGAN's generator), the JAX side's read
  from its optimizer's state after the step (Adam's first moment is 0.1 of
  it, the SGD trace the gradient, plus the decayed weights for the bi
  trainer's);
- a codebook on every code but the two that a row at a near-tie moved: at
  world N the gray -> IR trainer's fusions, whose batch norms divide by a
  variance near their eps, carry the ranks' summing order to 2e-5 of the
  quantizers' input, where one row's two nearest codes lie 6e-5 apart
  (relative); such a count must differ by whole rows (0.01 a row), at most
  one row a quantizer, and that trainer's metrics and statistics are held
  to its own tolerances against the one-process step too (a moved count
  renormalises every code of its codebook);
- against the one-process port step: the metrics rtol 1e-5 / atol 1e-6 up
  to the first optimizer update of the step, and those computed after it
  to the tolerances against JAX (the first update of a near-zero gradient
  element is about ``lr * sign(g)``, a sign the summing order can flip);
  statistics and codebooks within 1e-5 of their largest element; each
  optimizer's gradient as against JAX (the train-mode batch norms over few
  rows make the toy gradient ill-conditioned, and the ranks add their sums
  in another order), and within 3e-2 where the optimizer follows another's
  update in the step (the generators of adaptive, the deep, gray -> IR and
  StarGAN trainers: the ReID net they run moved by the flipped signs above;
  measured 1.1e-2 for adaptive's between a world of 2 and one process);
- every rank's parameters, buffers and gradients bit-equal to rank 0's (by
  digests: the other ranks return those and their metrics); a group of one
  rank, which stands for the one-process step above, bit-equal to no group
  for the deep and StarGAN trainers (the gathers, all three optimizers).
"""

import contextlib
import functools
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
import vqvae2_tpu.models.adaptive as ja
import vqvae2_tpu.models.stargan as js
from test_torch_train_adaptive import seeded as adaptive_seeded
from test_torch_train_stargan_bi import Narrow
from test_torch_train_stargan_bi import init_shapes as stargan_shapes
from test_torch_train_stargan_bi import seeded as stargan_seeded
from test_torch_train_vqvae_deep import seeded as deep_seeded
from test_torch_train_vqvae_deep_bi import init_shapes as bi_shapes
from test_torch_train_vqvae_deep_bi import seeded as bi_seeded
from vqvae2_tpu import parallel as jpar
from vqvae2_tpu.train import adaptive as jad
from vqvae2_tpu.train import gray2color as jg2c
from vqvae2_tpu.train import reid as jreid
from vqvae2_tpu.train import stargan_bi as jsb
from vqvae2_tpu.train import vqvae_deep as jtd
from vqvae2_tpu.train import vqvae_deep_bi as jbi
from vqvae2_tpu.train import vqvae_deep_ir as jir
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.train import gray2color as tg2c
from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
from vqvae2_tpu_torch.utils.jax_import import (adaptive_deep_from_jax, adaptive_from_jax,
                                                stargan_from_jax)

P, K, CLASSES = 2, 4, 4
HW, GAN_HW = (64, 32), (64, 64)
LR, LR_F = 3e-4, 0.1
NARROW = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
KINDS = ("adaptive", "gray2color", "vqvae_deep", "vqvae_deep_bi", "vqvae_deep_ir",
         "stargan_bi")
METRIC_TOL = {k: dict(rtol=1e-4, atol=1e-5) for k in KINDS}
METRIC_TOL["gray2color"] = dict(rtol=1e-3, atol=1e-5)
IR_GEN_METRICS = ("latent", "id_ir", "feat_ir", "disc_fake", "loss_gen")
GAN_AFTER_REID = ("id_ir", "feat_ir", "hinge_pos", "loss_gen")
STATS_RTOL = {k: 1e-4 for k in KINDS}
STATS_RTOL["vqvae_deep_ir"] = 1e-3
GRAD_RTOL = {"adaptive": {"reid": 1e-2, "gen": 1e-2}, "gray2color": {"all": 3e-2},
             "vqvae_deep": {"reid": 1e-2, "gen": 1e-2},
             "vqvae_deep_bi": {"reid": 3e-2, "gen": 1e-2},
             "vqvae_deep_ir": {"reid": 3e-2, "gen": 3e-2},
             "stargan_bi": {"reid": 3e-2, "gen": 3e-1, "disc": 1e-2}}
# metrics computed after an optimizer of the step has updated: the update of
# a near-zero gradient element is about lr * sign(g), whose sign the summing
# order can flip, so these are held to their trainer's tolerances against JAX
AFTER_UPDATE = {"adaptive": ("mse", "latent", "id_fake", "kl_fake", "feat", "loss_gen"),
                "vqvae_deep": ("recon", "recon_feat", "latent", "id_ir", "feat_ir", "loss_gen"),
                "vqvae_deep_ir": IR_GEN_METRICS,
                "stargan_bi": ("cycle", "id_ir", "feat_ir", "g_adv", "hinge_pos", "hinge_neg",
                               "loss_gen", "loss_disc", "d_real", "d_fake", "r1")}
# the optimizers whose gradient follows another optimizer's update in the step
AFTER_UPDATE_GROUPS = ("adaptive/gen", "vqvae_deep/gen", "vqvae_deep_ir/gen", "stargan_bi/gen")
PORT_AFTER_UPDATE_GRAD_RTOL = 3e-2
PORT_METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
PORT_STATS_RTOL = 1e-5
GRAY_W = (np.random.default_rng(40).uniform(size=(P * K, 3)) + 0.01).astype(np.float32)
GRAY_W /= GRAY_W.sum(1, keepdims=True)


def cfg(kind):
    return dict(classes=CLASSES, K=K, lr=LR if kind != "stargan_bi" else 1e-4, lr_f=LR_F,
                hw=GAN_HW if kind == "stargan_bi" else HW, narrow=NARROW, gray_w=GRAY_W)


_SCRATCH = []


def scratch_dir(name: str) -> str:
    """A directory for this module's data, removed when the process ends."""
    d = tempfile.TemporaryDirectory(prefix=f"{name}_")
    _SCRATCH.append(d)
    return d.name


@functools.lru_cache(maxsize=None)
def sysu_dir(hw):
    return jreid.make_synthetic_sysu(scratch_dir("sysu"), n_ids=CLASSES,
                                     per_id=4, h=hw[0], w=hw[1])


@functools.lru_cache(maxsize=None)
def batch_of(kind):
    """The global batch of a trainer, numpy arrays as its loop builds them."""
    ds = tsysu.SYSUData(sysu_dir(cfg(kind)["hw"]), part=False, seed=0)
    ds.samplize(P, K)
    it = tds.epoch_row_batches(ds, P * K)
    rows = next(it)
    it.close()
    if kind in ("vqvae_deep_bi", "vqvae_deep_ir", "stargan_bi"):
        b = tbi.cross_modal_batch(rows, np.random.default_rng(5), "cpu")
        return {k: v.numpy() for k, v in b.items()}
    b = {"rgb": np.stack([r[0] for r in rows]), "ir": np.stack([r[1] for r in rows]),
         "label": np.asarray([r[2] for r in rows], np.int32)}
    if kind == "gray2color":
        b["ids"] = tg2c.other_instance_ids(P, K, np.random.default_rng(5))
    return b


@contextlib.contextmanager
def jax_patches():
    """The JAX side's ``VQVAE_Deep`` narrowed and the deep trainer's gray
    mix pinned, while the steps are built and traced (held while any thread
    is inside)."""
    with _PATCH_LOCK:
        _PATCHES[0] += 1
        if _PATCHES[0] == 1:
            _PATCHES.append((ja.VQVAE_Deep, jtd.random_gray))
            ja.VQVAE_Deep = functools.partial(ja.VQVAE_Deep, **NARROW)
            jtd.random_gray = lambda r, img: jnp.repeat(
                jnp.einsum("bhwc,bc->bhw", img, GRAY_W)[..., None], 3, -1)
    try:
        yield
    finally:
        with _PATCH_LOCK:
            _PATCHES[0] -= 1
            if _PATCHES[0] == 0:
                ja.VQVAE_Deep, jtd.random_gray = _PATCHES.pop()


_PATCH_LOCK = threading.Lock()
_PATCHES = [0]


def all_jax_steps():
    """Every trainer's JAX step, three at a time (XLA compiles them off the
    interpreter's lock)."""
    from concurrent.futures import ThreadPoolExecutor

    for kind in KINDS:
        start(kind)
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(jax_step, KINDS))


def probe_shapes(jm, probe, hw):
    return jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *hw, 3)), method=probe))


@functools.lru_cache(maxsize=None)
def start(kind):
    """``(JAX module, seeded variables, port state_dict)`` of a trainer."""
    with jax_patches():
        if kind in ("adaptive", "gray2color"):
            jm = ja.ModelAdaptive(class_num=CLASSES)
            probe = jad._init_probe if kind == "adaptive" else jg2c._init_probe
            v = adaptive_seeded(probe_shapes(jm, probe, HW), 31 if kind == "adaptive" else 41)
            return jm, v, adaptive_from_jax(v)
        if kind in ("vqvae_deep", "vqvae_deep_ir"):
            jm = ja.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
            v = deep_seeded(probe_shapes(jm, jm.init_probe, HW), 21)
            return jm, v, adaptive_deep_from_jax(v)
        if kind == "vqvae_deep_bi":
            jm = ja.ModelAdaptiveBi_Deep(class_num=CLASSES)
            v = bi_seeded(bi_shapes(jm, 2 * K), 31)
            return jm, v, adaptive_from_jax(v)
    jm = js.ModelStarGAN(class_num=CLASSES, img_size=Narrow(64))
    v = stargan_seeded(stargan_shapes(jm, 2 * K), 51)
    return jm, v, stargan_from_jax(v)


def to_port(kind, tree):
    if kind == "stargan_bi":
        return stargan_from_jax(tree)
    if kind in ("vqvae_deep", "vqvae_deep_ir"):
        return adaptive_deep_from_jax(tree)
    return adaptive_from_jax(tree)


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@functools.lru_cache(maxsize=None)
def jax_step(kind):
    """The JAX step on the batch laid over the 8 virtual devices: its
    metrics and the port ``state_dict`` after it."""
    jm, v, _ = start(kind)
    mesh = jpar.make_mesh(jax.devices())
    batch = dict(batch_of(kind))
    ids = batch.pop("ids", None)
    sharded = jpar.shard_batch(batch, mesh)
    cols = {k: v[k] for k in ("params", "batch_stats", "vq_stats") if k in v}
    rng = jax.random.PRNGKey(0)
    adam = optax.adam
    with jax_patches():
        if kind == "adaptive":
            reid, gen = jad._split(v["params"])
            state = jad.AdaptiveState(step=jnp.zeros((), jnp.int32), **cols,
                                      opt_reid=adam(LR).init(reid), opt_gen=adam(LR).init(gen))
            state, (metrics, _, _) = jad.make_train_step(jm, adam(LR), adam(LR), K)(
                state, sharded, rng)
        elif kind == "gray2color":
            state = jg2c.G2CState(step=jnp.zeros((), jnp.int32), **cols,
                                  opt_state=adam(LR).init(v["params"]))
            state, (metrics, _) = jg2c.make_train_step(jm, adam(LR))(
                state, sharded, jnp.asarray(ids), rng)
        elif kind in ("vqvae_deep", "vqvae_deep_ir"):
            reid, gen = jtd._split_params(v["params"])
            state = jtd.DeepState(step=jnp.zeros((), jnp.int32), **cols,
                                  opt_reid=adam(LR).init(reid), opt_gen=adam(LR).init(gen))
            fn = (jtd.make_train_step(jm, adam(LR), adam(LR), K) if kind == "vqvae_deep"
                  else jir.make_full_step(jm, adam(LR), adam(LR), K))
            state, metrics = fn(state, sharded, rng)
        elif kind == "vqvae_deep_bi":
            reid, gen = jbi._split(v["params"])
            tx_reid = optax.chain(optax.add_decayed_weights(5e-4), optax.sgd(
                jbi.reid_lr_schedule(LR_F, 1), momentum=0.9, nesterov=True))
            state = jbi.BiState(step=jnp.zeros((), jnp.int32), **cols,
                                opt_reid=tx_reid.init(reid), opt_gen=adam(LR).init(gen))
            state, metrics = jbi.make_train_step(jm, tx_reid, adam(LR), K)(state, sharded,
                                                                          rng)
        else:
            reid, gen, disc = jsb._split(v["params"])
            tx_reid = optax.sgd(LR_F, momentum=0.9, nesterov=True)
            state = jsb.GanState(step=jnp.zeros((), jnp.int32), **cols,
                                 opt_reid=tx_reid.init(reid), opt_gen=adam(1e-4).init(gen),
                                 opt_disc=adam(1e-4).init(disc))
            knobs = {"r1_weight": jnp.float32(1.0), "adv_weight": jnp.float32(0.5),
                     "d_mask": jnp.float32(1.0)}
            state, metrics = jsb.make_train_step(jm, tx_reid, adam(1e-4), adam(1e-4), K)(
                state, sharded, rng, knobs)
    after = {k: getattr(state, k) for k in ("params", "batch_stats", "vq_stats")
             if hasattr(state, k)}
    return ({k: float(x) for k, x in metrics.items()}, to_port(kind, host(after)),
            jax_gradients(kind, state, v["params"]))


def jax_gradients(kind, state, params_before):
    """Each parameter's gradient of the JAX step, from its optimizer's state
    after one step: Adam's first moment is 0.1 of it, the SGD trace the
    gradient (plus the decayed weights, for the bi trainer's)."""
    trees = []
    if kind == "gray2color":
        trees.append(jax.tree_util.tree_map(lambda m: m / 0.1, state.opt_state[0].mu))
    else:
        for opt in ("opt_reid", "opt_gen", "opt_disc"):
            st = getattr(state, opt, None)
            if st is None:
                continue
            if kind == "vqvae_deep_bi" and opt == "opt_reid":
                reid, _ = jbi._split(params_before)
                trees.append(jax.tree_util.tree_map(lambda t, p: t - 5e-4 * p,
                                                    st[1][0].trace, reid))
            elif kind == "stargan_bi" and opt == "opt_reid":
                trees.append(st[0].trace)
            else:
                trees.append(jax.tree_util.tree_map(lambda m: m / 0.1, st[0].mu))
    merged = {}
    for t in trees:
        merged.update(host(t))
    return to_port(kind, {"params": merged})


def jobs():
    return [("adaptation_step", (kind, start(kind)[2], cfg(kind), batch_of(kind)))
            for kind in KINDS]


# the trainers whose step a process without a group also takes, to hold a
# group of one rank to it bit for bit: the gathers and all three optimizers
NO_GROUP = ("vqvae_deep", "stargan_bi")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and 3 ranks, a group of one rank (the one-process
    step) and one process without a group (0) for ``NO_GROUP``, each in
    processes of its own; the JAX steps run here meanwhile."""
    return ranks.run_worlds(
        (2, 3, 1, 0), tmp_path_factory,
        lambda n: [j for j in jobs() if n or j[1][0] in NO_GROUP], meanwhile=all_jax_steps)


@pytest.fixture(scope="module")
def single(worlds):
    """The one-process step: a group of one rank, bit-equal to no group
    (below)."""
    return worlds[1][0]


@pytest.fixture(scope="module", params=[2, 3])
def world(request, worlds):
    return request.param, worlds[request.param]


def groups(kind, names):
    """Each parameter's optimizer, as ``(group, kind of update)``."""
    out = {}
    for n in names:
        if kind == "gray2color":
            out[n] = ("all", "adam")
        elif kind == "stargan_bi":
            out[n] = (("reid", "sgd") if n.startswith("person_id.") else
                      ("disc", "adam") if n.startswith("discriminator.") else ("gen", "adam"))
        elif kind == "vqvae_deep_bi":
            out[n] = (("reid", "sgd") if n.startswith(("person_id.", "discriminator."))
                      else ("gen", "adam"))
        else:
            out[n] = ("reid", "adam") if n.startswith("person_id.") else ("gen", "adam")
    return out


def by_group(kind, tensors_a, tensors_b):
    """``{group: (error norm, norm of b)}`` over the parameters of each
    optimizer."""
    acc = {}
    for n, (g, _) in groups(kind, tensors_b).items():
        a, b = tensors_a[n].double(), tensors_b[n].double()
        e, s = acc.get(g, (0.0, 0.0))
        acc[g] = (e + float(torch.sum((a - b) ** 2)), s + float(torch.sum(b ** 2)))
    return {g: (e ** 0.5, s ** 0.5) for g, (e, s) in acc.items()}


def is_stat(name):
    return name.endswith(("running_mean", "running_var", "embed", "embed_avg", "cluster_size",
                          "_u", "_sigma", ".u", ".sigma"))


def moved_codes(got, want, rtol):
    """``{quantizer: codes}`` whose EMA count differs: a row whose nearest
    code is a near-tie took the other one.  Each such count must differ by
    whole rows (``1 - decay`` = 0.01 a row a step)."""
    moved = {}
    for name, w in want.items():
        if name.endswith("cluster_size"):
            diff = (got[name] - w).abs()
            codes = torch.nonzero(diff > rtol * float(w.abs().max())).flatten()
            rows = diff[codes] / 0.01
            assert bool(torch.all((rows - rows.round()).abs() < 1e-2)), (name, diff[codes])
            moved[name[:-len("cluster_size")]] = codes
    return moved


def assert_stats(got, want, rtol, what):
    """Statistics and codebooks within ``rtol`` of their largest element; a
    codebook on every code but those a near-tie row moved (at most one such
    row a quantizer)."""
    moved = moved_codes(got, want, rtol)
    assert all(len(c) <= 2 for c in moved.values()), (what, moved)
    for name, w in want.items():
        if name in got and is_stat(name) and w.is_floating_point():
            g = got[name]
            q = name.rsplit(".", 1)[0] + "."
            if q in moved and len(moved[q]):
                keep = torch.ones(w.shape[0], dtype=torch.bool)
                keep[moved[q]] = False
                g, w = g[keep], w[keep]
            err = float((g - w).abs().max())
            assert err <= rtol * max(float(w.abs().max()), 1e-6), (what, name, err)


@pytest.mark.parametrize("job", range(len(KINDS)), ids=KINDS)
def test_step_is_the_jax_sharded_step(world, job):
    """Rank 0's step (every rank's is rank 0's, below)."""
    kind = KINDS[job]
    n, results = world
    metrics, after, grads = jax_step(kind)
    got = results[0][job]
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, **jax_metric_tol(kind, k),
                                   err_msg=f"{kind} {k}")
    assert_stats(got["state"], after, STATS_RTOL[kind], kind)
    assert_grads(kind, got["grads"], grads)


def jax_metric_tol(kind, k):
    if kind == "vqvae_deep_ir" and k in IR_GEN_METRICS:
        return dict(rtol=5e-4, atol=1e-5)
    if kind == "stargan_bi" and k in GAN_AFTER_REID:
        return dict(rtol=2e-2, atol=1e-5)
    return METRIC_TOL[kind]


def assert_grads(kind, got, want, after_update_rtol=None):
    """Each optimizer's gradient as one vector within its trainer's
    tolerance of ``want`` (``after_update_rtol`` for one that follows
    another optimizer's update, where given); every parameter the one side
    reaches, the other reaches too."""
    assert set(got) <= set(want), set(got) - set(want)
    full = {n: got.get(n, torch.zeros_like(w)) for n, w in want.items()}
    for g, (err, norm) in by_group(kind, full, want).items():
        rtol = GRAD_RTOL[kind][g]
        if after_update_rtol and f"{kind}/{g}" in AFTER_UPDATE_GROUPS:
            rtol = max(rtol, after_update_rtol)
        assert err <= rtol * norm + 1e-12, (kind, g, err / max(norm, 1e-30))


@pytest.mark.parametrize("job", range(len(KINDS)), ids=KINDS)
def test_step_is_the_single_process_step(world, single, job):
    kind = KINDS[job]
    n, results = world
    want = single[job]
    for res in results:
        for k, v in want["metrics"].items():
            tol = PORT_METRIC_TOL
            if k in AFTER_UPDATE.get(kind, ()) or kind == "vqvae_deep_ir":
                tol = jax_metric_tol(kind, k)
            np.testing.assert_allclose(res[job]["metrics"][k], v, **tol,
                                       err_msg=f"{kind} {k}")
    got = results[0][job]
    assert_stats(got["state"], want["state"],
                 STATS_RTOL[kind] if kind == "vqvae_deep_ir" else PORT_STATS_RTOL, kind)
    assert set(got["grads"]) == set(want["grads"])
    assert_grads(kind, got["grads"], want["grads"], PORT_AFTER_UPDATE_GRAD_RTOL)


def test_every_rank_holds_rank_0s_state(world):
    """Parameters, buffers and gradients, bit for bit (by digests)."""
    n, results = world
    for job, kind in enumerate(KINDS):
        assert results[0][job]["digests"] == ranks.slim(0, results[0][job])["digests"]
        for res in results[1:]:
            assert res[job]["digests"] == results[0][job]["digests"], kind


def test_a_world_of_one_is_bit_equal_to_no_group(worlds):
    for want, kind in zip(worlds[0][0], NO_GROUP):
        got = worlds[1][0][KINDS.index(kind)]
        assert got["metrics"] == want["metrics"], kind
        assert got["digests"] == want["digests"], kind


def raw_sysu(root):
    """A raw SYSU-MM01 tree (cam1..cam6/<id>/<n>.jpg and the test ids)."""
    from PIL import Image

    (root / "exp").mkdir(parents=True)
    (root / "exp" / "test_id.txt").write_text("1,2,3\n")
    g = np.random.default_rng(12)
    for cam in range(1, 7):
        for pid in (1, 2, 3):
            (root / f"cam{cam}" / f"{pid:04d}").mkdir(parents=True)
            Image.fromarray(g.integers(0, 255, size=(64, 32, 3)).astype(np.uint8)).save(
                root / f"cam{cam}" / f"{pid:04d}" / "0001.jpg")
    return str(root)


def test_primary_only_eval_samples_and_checkpoints_end_at_world_2(tmp_path):
    """``train.vqvae_deep.main`` at world 2: two steps, a validation of the
    ReID net, a sample grid and the checkpoints, from the primary rank alone
    (eval mode: no collective); both ranks end, and agree on the metrics."""
    raw = raw_sysu(tmp_path / "SYSU-MM01")
    argv = ["--synthetic", "--device", "cpu", "--steps", "2", "--batch_size", "2",
            "--num_pos", "2", "--log_every", "1", "--eval_every", "1", "--eval_path", raw,
            "--sample_dir", str(tmp_path / "s"), "--sample_every", "2", "--ckpt_dir",
            str(tmp_path / "ck"), "--metrics_csv", str(tmp_path / "m.csv")]
    out = ranks.run_world(2, tmp_path / "w", [("adaptation_main", ("vqvae_deep", argv,
                                                                    NARROW))])
    m0, m1 = out[0][0]["metrics"], out[1][0]["metrics"]
    assert m0 == m1 and 0.0 <= m0["mAP"] <= 1.0 and np.isfinite(m0["loss_gen"])
    assert (tmp_path / "s" / "00002.png").exists()
    assert (tmp_path / "ck" / "last.pt").exists() and (tmp_path / "ck" / "best.pt").exists()
    with open(tmp_path / "m.csv") as f:
        assert len(f.read().strip().splitlines()) == 3          # a header, one row a step
