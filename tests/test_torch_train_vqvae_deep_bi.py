"""The port's ``train/vqvae_deep_bi.py`` against the JAX package's: the
warmup-and-step ReID schedule, the batch the command line builds (the gray
mix, then the two augmented views, from one ``np.random.Generator`` in the
JAX package's order), ``ModelAdaptiveBi_Deep`` as the trainer's init probe
creates it (no fusions), and one and two steps of ``make_train_step`` from
the same weights and batch: every loss, the codebooks and the batch-norm
statistics after the step (the generator step runs the ReID net in eval mode
and moves none of its statistics; the ReID step moves them), the ReID
optimizer's momentum (optax's trace; ``add_decayed_weights(5e-4)`` then
Nesterov SGD over ``person_id`` and ``discriminator``) and the generator's
Adam moments.  Then the command line on the CPU and the default device.

Model: ``ModelAdaptiveBi_Deep`` (resnet18, four identities) on a narrowed
``VQVAE_Deep`` (channel 16, one residual block of 8, ``embed_dim`` 8, 16
codes), patched in on both sides; images 64x32, P = K = 2; seeded weights
carried across by ``adaptive_from_jax``; one epoch a step, so the second step
runs at twice the first one's learning rate.

Tolerances: the losses rtol 1e-4 / atol 1e-5; codebooks and statistics
within 1e-4 of their largest element.  Each optimizer's gradient as one
vector (Adam's first moment; the SGD trace, which is the ReID net's
gradient plus its decay) within 1e-2 of its norm for the generators and
3e-2 for the ReID net, each tensor's within 1e-1 of its own norm or of the
group's mean norm a tensor.  The ReID net's gradient at this toy size is
ill-conditioned: in float64, noise of 1e-5 on its input images moves it by
1-2 % of its norm (ReLU and max-pool kinks, with the batch norms over four
rows; measured on the warped views the step sees), and the two packages'
fp32 activations differ by about that much; measured 1.2 % here, while the
port's fp32 gradient lies 2.6e-4 of its norm from its own float64 one.  The
port's change is its optimizer's rule on its own state (rtol 1e-4 plus an
fp32 ulp); the two sides' changes within 3e-2 of their norm for SGD (linear
in the gradient) and 3e-1 for Adam (its first steps move a weight by about
``lr * sign(g)``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vqvae2_tpu.models.adaptive as ja
from vqvae2_tpu.train import reid as jreid
from vqvae2_tpu.train import vqvae_deep_bi as jbi
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.models import adaptive as ta
from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import adaptive_from_jax

HW = (64, 32)
P, K = 2, 2
CLASSES = 4
LR, LR_F = 3e-4, 0.1
NARROW = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = {"sgd": 3e-2, "adam": 1e-2}
TENSOR_GRAD_RTOL = 1e-1
STEP_RTOL = {"sgd": 3e-2, "adam": 3e-1}
STATS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def seeded(shapes, seed):
    g = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", str(path[-1]))
        if leaf in ("embed", "embed_avg"):
            return g.normal(size=s.shape).astype(np.float32)
        if leaf == "cluster_size":
            return g.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if leaf == "var":
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_shapes(jm, n):
    """The variables the JAX trainer's ``init_probe`` creates (its lines)."""
    probe = jnp.zeros((n, *HW, 3), jnp.float32)

    def init_probe(module):
        feat, _, f2d, _, f3 = module.person_id(xRGB=probe, xIR=probe, modal=0,
                                               with_feature=True)
        module.person_id(xZ=probe, modal=3)
        featV, featI = jnp.split(feat, 2, axis=0)
        jbi._cycle_forward(module, probe, probe, featV, featI)
        return module.discriminate(feat)

    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                           "dropout": jax.random.PRNGKey(1)},
                                          method=init_probe))


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(ja, "VQVAE_Deep", functools.partial(ja.VQVAE_Deep, **NARROW))
    monkeypatch.setattr(ta, "VQVAE_Deep", functools.partial(ta.VQVAE_Deep, **NARROW))


@pytest.fixture(scope="module")
def sysu_dir(tmp_path_factory):
    return jreid.make_synthetic_sysu(str(tmp_path_factory.mktemp("sysu")), n_ids=CLASSES,
                                     per_id=4, h=HW[0], w=HW[1])


def row_batches(sysu_dir, n):
    ds = tsysu.SYSUData(sysu_dir, part=False, seed=0)
    ds.samplize(P, K)
    it = tds.epoch_row_batches(ds, P * K)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def test_reid_lr_schedule_is_the_jax_packages():
    got, want = tbi.reid_lr_schedule(0.1, 3), jbi.reid_lr_schedule(0.1, 3)
    for step in (0, 1, 2, 3, 29, 30, 59, 60, 149, 150, 400):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=step)


def test_the_batch_is_the_jax_loops(sysu_dir, monkeypatch):
    """``cross_modal_batch`` draws the gray mix, then the RGB and the IR
    augmentation, as the JAX trainer's loop does (its lines, with its cv2
    augmentation patched in on the port's side so the arrays are equal)."""
    rows = row_batches(sysu_dir, 1)[0]
    monkeypatch.setattr(tbi, "aug_transforms", jbi.aug_transforms)
    got = tbi.cross_modal_batch(rows, np.random.default_rng(3), "cpu")
    host_rng = np.random.default_rng(3)
    rgb = np.stack([r[0] for r in rows])
    ir = np.stack([r[1] for r in rows])
    wmix = host_rng.random((len(rgb), 3)) + 0.01
    wmix /= wmix.sum(axis=1, keepdims=True)
    gray = np.repeat(np.einsum("bhwc,bc->bhw", rgb, wmix)[..., None], 3, axis=-1).astype(
        np.float32)
    # the JAX loop's batch also holds "rgb", which its step never reads
    want = {"ir": ir, "gray": gray, "aug_rgb": jbi.aug_transforms(rgb, host_rng),
            "aug_ir": jbi.aug_transforms(ir, host_rng),
            "label": np.asarray([r[2] for r in rows], np.int32)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_the_model_is_the_init_probes(narrow):
    """No fusions: the trainer's init probe never calls them, so flax
    creates none."""
    shapes = init_shapes(ja.ModelAdaptiveBi_Deep(class_num=CLASSES), 2 * K)
    assert sorted(shapes["params"]) == ["adaptor1", "adaptor2", "discriminator", "person_id"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    mapped = adaptive_from_jax(zeros)
    ours = ta.ModelAdaptiveBi_Deep(class_num=CLASSES).state_dict()
    assert sorted(mapped) == sorted(ours)
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(ours[k].shape), k


def jax_vars(state):
    return host({"params": state.params, "batch_stats": state.batch_stats,
                 "vq_stats": state.vq_stats})


def jax_moments(state):
    """``{port name: (kind, first moment, second moment or None)}`` and the
    Adam count, from the two optax states."""
    trace = state.opt_reid[1][0].trace
    adam = state.opt_gen[0]
    out = {}
    for name, m in adaptive_from_jax({"params": host(trace)}).items():
        out[name] = ("sgd", m, None)
    mu, nu = (adaptive_from_jax({"params": host(t)}) for t in (adam.mu, adam.nu))
    for name in mu:
        out[name] = ("adam", mu[name], nu[name])
    return out, int(adam.count)


def sync(model, tstate, state):
    """The JAX state after a step into the port's: parameters, statistics,
    codebooks, the SGD trace and Adam's moments."""
    model.load_state_dict(adaptive_from_jax(jax_vars(state)))
    moments, count = jax_moments(state)
    reid, _ = tbi._split(model)
    reid = {id(p) for p in reid}
    for name, p in model.named_parameters():
        kind, m, v = moments[name]
        if id(p) in reid:
            tstate.opt_reid.state[p] = {"momentum_buffer": m.clone()}
        else:
            tstate.opt_gen.state[p] = {"step": torch.tensor(float(count)),
                                       "exp_avg": m.clone(), "exp_avg_sq": v.clone()}


def adam_change(m, v, t, lr=LR, b1=0.9, b2=0.999, eps=1e-8):
    return -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def assert_same_step(model, tstate, state, before, want_before, lr_reid):
    """Each optimizer's moments against the JAX side's by norms, the port's
    change against its own rule, the two sides' changes by norms."""
    moments, count = jax_moments(state)
    want, want_before = adaptive_from_jax(jax_vars(state)), adaptive_from_jax(want_before)
    got = model.state_dict()
    reid, _ = tbi._split(model)
    reid = {id(p) for p in reid}
    groups = {}
    for name, p in model.named_parameters():
        kind, m_want, _ = moments[name]
        d_got = (got[name] - before[name]).double()
        ulp = torch.finfo(torch.float32).eps * before[name].double().abs()
        if id(p) in reid:
            assert kind == "sgd", name
            m_got = tstate.opt_reid.state[p]["momentum_buffer"].double()
            g = p.grad.double() + 5e-4 * before[name].double()
            rule = -lr_reid * (g + 0.9 * m_got)
            # fp32 sums of terms that may cancel
            ulp = ulp + 4 * torch.finfo(torch.float32).eps * lr_reid * (g.abs()
                                                                        + 0.9 * m_got.abs())
        else:
            assert kind == "adam", name
            st = tstate.opt_gen.state[p]
            m_got = st["exp_avg"].double()
            rule = adam_change(m_got, st["exp_avg_sq"].double(), count)
        assert bool(torch.all((d_got - rule).abs() <= 1e-4 * rule.abs() + ulp + 1e-12)), name
        groups.setdefault(kind, []).append(
            (name, m_got, m_want.double(), d_got, (want[name] - want_before[name]).double()))
    assert sorted(groups) == ["adam", "sgd"]
    for kind, items in groups.items():
        norm2 = lambda k: sum(float(torch.sum(it[k] ** 2)) for it in items)   # noqa: E731
        g_err = sum(float(torch.sum((it[1] - it[2]) ** 2)) for it in items) ** 0.5
        assert g_err <= GRAD_RTOL[kind] * norm2(2) ** 0.5, (kind, g_err / norm2(2) ** 0.5)
        mean_norm = norm2(2) ** 0.5 / len(items) ** 0.5
        for name, a, b, _, _ in items:
            err, own = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
            assert err <= TENSOR_GRAD_RTOL * max(own, mean_norm), (name, err, own, mean_norm)
        s_err = sum(float(torch.sum((it[3] - it[4]) ** 2)) for it in items) ** 0.5
        assert s_err <= STEP_RTOL[kind] * norm2(4) ** 0.5, (kind, s_err / norm2(4) ** 0.5)


def assert_buffers(model, want):
    want = adaptive_from_jax(want)
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        err = float(np.abs(buf.numpy() - w).max())
        assert err <= STATS_RTOL * max(float(np.abs(w).max()), 1e-6), (name, err)


def test_one_and_two_steps(sysu_dir, narrow):
    jm = ja.ModelAdaptiveBi_Deep(class_num=CLASSES)
    variables = seeded(init_shapes(jm, 2 * K), 31)
    reid, gen = jbi._split(variables["params"])
    tx_reid = optax.chain(optax.add_decayed_weights(5e-4),
                          optax.sgd(jbi.reid_lr_schedule(LR_F, 1), momentum=0.9, nesterov=True))
    tx_gen = optax.adam(LR)
    state = jbi.BiState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], vq_stats=variables["vq_stats"],
                        opt_reid=tx_reid.init(reid), opt_gen=tx_gen.init(gen))
    step = jbi.make_train_step(jm, tx_reid, tx_gen, K)

    model = ta.ModelAdaptiveBi_Deep(class_num=CLASSES)
    model.load_state_dict(adaptive_from_jax(variables))
    ttx_reid = schedules.SGDSchedule(tbi.reid_lr_schedule(LR_F, 1), weight_decay=5e-4)
    ttx_gen = schedules.adam(LR)
    tstate = tbi.create_state(model, ttx_reid, ttx_gen)
    tstep = tbi.make_train_step(model, ttx_reid, ttx_gen, K)

    host_rng = np.random.default_rng(5)
    for i, rows in enumerate(row_batches(sysu_dir, 2)):
        batch = tbi.cross_modal_batch(rows, host_rng, "cpu")
        if i:
            sync(model, tstate, state)
        want_before = jax_vars(state)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, jm_metrics = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                                 jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm_metrics) == {"cycle", "latent", "id_ir", "feat_ir",
                                              "disc_fake", "loss_gen", "loss_reid"}
        for k in jm_metrics:
            np.testing.assert_allclose(float(tm[k]), float(jm_metrics[k]), **METRIC_TOL,
                                       err_msg=k)
        assert_same_step(model, tstate, state, before, want_before,
                         tbi.reid_lr_schedule(LR_F, 1)(i))
        assert_buffers(model, jax_vars(state))
        assert tstate.step == int(state.step) == i + 1
    assert all(p.requires_grad for p in model.parameters()) and model.person_id.training


def test_the_cycle_loss_rises_at_first_in_jax_too(sysu_dir, narrow):
    """Five steps of both packages, each from its own state, on one batch at
    the command line's rates: the cycle loss of the JAX package's trainer
    rises more than fivefold by the fifth step (the ReID step moves the
    styles the decoders take; measured 1.39 -> 26,114), and the port's with
    it; the first two steps agree within 1e-4.  The rise amplifies the
    rounding, so the later steps are compared by their rise alone."""
    jm = ja.ModelAdaptiveBi_Deep(class_num=CLASSES)
    variables = seeded(init_shapes(jm, 2 * K), 31)
    reid, gen = jbi._split(variables["params"])
    tx_reid = optax.chain(optax.add_decayed_weights(5e-4),
                          optax.sgd(jbi.reid_lr_schedule(LR_F, 1), momentum=0.9, nesterov=True))
    tx_gen = optax.adam(LR)
    state = jbi.BiState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], vq_stats=variables["vq_stats"],
                        opt_reid=tx_reid.init(reid), opt_gen=tx_gen.init(gen))
    step = jbi.make_train_step(jm, tx_reid, tx_gen, K)
    model = ta.ModelAdaptiveBi_Deep(class_num=CLASSES)
    model.load_state_dict(adaptive_from_jax(variables))
    ttx_reid = schedules.SGDSchedule(tbi.reid_lr_schedule(LR_F, 1), weight_decay=5e-4)
    ttx_gen = schedules.adam(LR)
    tstate = tbi.create_state(model, ttx_reid, ttx_gen)
    tstep = tbi.make_train_step(model, ttx_reid, ttx_gen, K)
    batch = tbi.cross_modal_batch(row_batches(sysu_dir, 1)[0], np.random.default_rng(5), "cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    cycles = []
    for _ in range(5):
        state, jm_metrics = step(state, jb, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        cycles.append((float(jm_metrics["cycle"]), float(tm["cycle"])))
    for want, got in cycles[:2]:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    (j0, t0), (j4, t4) = cycles[0], cycles[4]
    assert j4 > 5 * j0 and t4 > 5 * t0, cycles


def test_the_generator_step_leaves_the_reid_statistics(sysu_dir, narrow):
    """The generator step's person_id passes run in eval mode: the running
    statistics after a step are what the ReID step alone makes of them."""
    import copy

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ta.ModelAdaptiveBi_Deep(class_num=CLASSES)
    twin = copy.deepcopy(model)
    batch = tbi.cross_modal_batch(row_batches(sysu_dir, 1)[0], np.random.default_rng(1), "cpu")
    seen = []
    handle = model.person_id.register_forward_hook(lambda m, a, out: seen.append(m.training))
    tx = schedules.SGDSchedule(0.0)
    state = tbi.create_state(model, tx, schedules.adam(0.0))
    try:
        tbi.make_train_step(model, tx, schedules.adam(0.0), K)(state, batch)
    finally:
        handle.remove()
    assert seen == [False, False, False, True, True, True]
    with ta.mode(twin.person_id, True), torch.no_grad():
        twin.person_id(xRGB=batch["aug_rgb"], xIR=batch["aug_ir"], modal=0, with_feature=True)
    stats = {n: b for n, b in model.person_id.named_buffers()}
    before = {n: b for n, b in twin.person_id.named_buffers()}
    assert stats and all(not torch.equal(stats[n], before[n]) for n in before
                         if n.startswith("visible_module"))


def test_main_on_the_cpu(tmp_path, narrow):
    """Two steps through the command line on a 64x32 tree with checkpoints,
    then a third by ``--resume``."""
    data = jreid.make_synthetic_sysu(str(tmp_path / "blobs"), n_ids=4, per_id=4, h=64, w=32)
    csv, ckpt = str(tmp_path / "m.csv"), str(tmp_path / "ck")
    common = ["--path", data, "--device", "cpu", "--batch_size", "2", "--num_pos", "2",
              "--log_every", "1", "--metrics_csv", csv, "--ckpt_dir", ckpt]
    m = tbi.main(common + ["--steps", "2"])
    assert np.isfinite(m["cycle"]) and np.isfinite(m["loss_reid"])
    saved = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
    assert saved["step"] == 2 and "adaptor2.dec.conv1.weight" in saved["model"]
    assert not any(k.startswith("fusion") for k in saved["model"])
    os.replace(os.path.join(ckpt, "last.pt"), os.path.join(ckpt, "step_0000002.pt"))
    tbi.main(common + ["--steps", "1", "--resume"])
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 3
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 4


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert tbi.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        tbi.main(["--synthetic", "--steps", "1", "--ckpt_dir", str(tmp_path / "ck")])
    assert os.listdir(str(tmp_path)) == []
