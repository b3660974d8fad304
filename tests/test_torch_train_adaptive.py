"""The port's ``train/adaptive.py`` and ``train/gray2color.py`` against the JAX
package's: one and two steps of each ``make_train_step`` from the same
weights and batch — every loss, the gradients of each optimizer, the
parameter changes, the batch-norm and spectral-norm statistics and the
codebooks; six steps of adaptive on one batch, where its generator loss
rises in both; ``other_instance_ids`` bit-equal for one numpy seed; the command
lines on the CPU (``--sched cycle``, sample grids, checkpoints, gray2color's
``--resume``) and the default device.

Model: ``ModelAdaptive`` (resnet18, four identities, the reference's VQ-VAE
widths) at 64x32, P = K = 2, seeded weights carried across by
``adaptive_from_jax``; gray2color's model has no IR decoder, as flax creates
none for it.

Tolerances as ``test_torch_train_vqvae_deep.py``'s, and for the same reasons
(gray2color's decoded images, which follow a train-mode fusion, within 3e-2
of their largest element, and its gradient within 3e-2 of its norm:
``FUSED_RTOL``, measured 1.1e-2 between the two sides; its losses rtol 1e-3,
measured 1.2e-4):
the losses rtol 1e-4 / atol 1e-5; the second step from the JAX side's state
after the first; each optimizer's gradient within 1e-2 of its norm, each
tensor's within 1e-1 of its own norm or of the group's mean norm a tensor;
the port's change is optax's update from its own moments; the two sides'
changes within 3e-1 of their norm (Adam's first steps move a weight by about
``lr * sign(g)``); statistics and codebooks within 1e-4 of their largest
element.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vqvae2_tpu.models.adaptive as ja
from vqvae2_tpu.train import adaptive as jad
from vqvae2_tpu.train import gray2color as jg2c
from vqvae2_tpu.train import reid as jreid
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.models import adaptive as ta
from vqvae2_tpu_torch.train import adaptive as tad
from vqvae2_tpu_torch.train import gray2color as tg2c
from vqvae2_tpu_torch.train.vqvae import TrainState
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import adaptive_from_jax

HW = (64, 32)
P, K = 2, 2
CLASSES = 4
LR = 3e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-2
TENSOR_GRAD_RTOL = 1e-1
STEP_RTOL = 3e-1
STATS_RTOL = 1e-4
# gray2color's images decoded from a fusion in train mode: its batch norm
# normalises an attention average (softmax of logits divided by the number of
# keys) that barely varies over a sample's positions, so it divides by a
# variance near its eps.  On the test's batch the fusion's output lies 1.7e-2
# of its largest element off a float64 run of the port for the JAX package,
# 2.3e-3 for the port.
FUSED_RTOL = 3e-2
FUSED_METRIC_TOL = dict(rtol=1e-3, atol=1e-5)
# six steps with each side on its own state: the train-mode batch norms'
# fp32 differences compound from step to step.  Measured at the sixth step:
# ``feat`` 1.1e-2, the other losses at most 3e-3; ``latent`` (the distance of
# the encoder's rows to their codes, both moved by every step) 3.3e-2.
SIX_STEP_RTOL = 3e-2
SIX_STEP_LATENT_RTOL = 1e-1

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one thread: the files run beside others in parallel
    workers, where each torch's pool of all the cores oversubscribes them."""
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
        if leaf.endswith("/sigma"):
            return np.ones(s.shape, np.float32)
        if leaf.endswith("/u") or leaf in ("embed", "embed_avg"):
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


def jax_variables(probe, seed):
    jm = ja.ModelAdaptive(class_num=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *HW, 3)), method=probe))
    return jm, seeded(shapes, seed)


@pytest.fixture(scope="module")
def sysu_dir(tmp_path_factory):
    return jreid.make_synthetic_sysu(str(tmp_path_factory.mktemp("sysu")), n_ids=CLASSES,
                                     per_id=4, h=HW[0], w=HW[1])


def batches(sysu_dir, n):
    ds = tsysu.SYSUData(sysu_dir, part=False, seed=0)
    ds.samplize(P, K)
    it = tds.epoch_row_batches(ds, P * K)
    out = []
    for _ in range(n):
        rows = next(it)
        out.append({"rgb": np.stack([r[0] for r in rows]), "ir": np.stack([r[1] for r in rows]),
                    "label": np.asarray([r[2] for r in rows], np.int32)})
    it.close()
    return out


def jax_vars(state):
    return host({"params": state.params, "batch_stats": state.batch_stats,
                 "vq_stats": state.vq_stats})


def moments(adam_states):
    """``(count, mu, nu)`` of each optax Adam state in ``adam_states``,
    merged, as port names."""
    counts = {}
    mu, nu = {}, {}
    for st in adam_states:
        for name in adaptive_from_jax({"params": host(st.mu)}):
            counts[name] = int(st.count)
        mu.update(adaptive_from_jax({"params": host(st.mu)}))
        nu.update(adaptive_from_jax({"params": host(st.nu)}))
    return counts, mu, nu


def sync(model, optimizer_of, adam_states, state):
    model.load_state_dict(adaptive_from_jax(jax_vars(state)))
    counts, mu, nu = moments(adam_states)
    for name, p in model.named_parameters():
        optimizer_of(name).state[p] = {"step": torch.tensor(float(counts[name])),
                                       "exp_avg": mu[name].clone(),
                                       "exp_avg_sq": nu[name].clone()}


def adam_change(m, v, t, lr=LR, b1=0.9, b2=0.999, eps=1e-8):
    return -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def assert_same_step(model, optimizer_of, adam_states, before, want, want_before,
                     grad_rtol=GRAD_RTOL):
    """As ``test_torch_train_vqvae_deep.assert_same_step``: gradients by
    group and by tensor, optax's rule on the port's moments, the changes."""
    counts, mu, _ = moments(adam_states)
    want, want_before = adaptive_from_jax(want), adaptive_from_jax(want_before)
    got = model.state_dict()
    groups = {}
    for name, p in model.named_parameters():
        st = optimizer_of(name).state[p]
        m_got = st.get("exp_avg", torch.zeros_like(p)).double()
        d_got = (got[name] - before[name]).double()
        if "exp_avg" in st:
            rule = adam_change(m_got, st["exp_avg_sq"].double(), counts[name])
            ulp = torch.finfo(torch.float32).eps * before[name].double().abs()
            assert bool(torch.all((d_got - rule).abs() <= 1e-4 * rule.abs() + ulp + 1e-12)), name
        else:
            assert float(mu[name].abs().max()) == 0.0 and not torch.any(d_got), name
        key = "reid" if name.startswith("person_id.") else "gen"
        groups.setdefault(key, []).append(
            (name, m_got, mu[name].double(), d_got, (want[name] - want_before[name]).double()))
    for group, items in groups.items():
        g_norm = sum(float(torch.sum(it[2] ** 2)) for it in items) ** 0.5
        if g_norm == 0.0:
            continue                    # gray2color's ReID net: no gradient on either side
        g_err = sum(float(torch.sum((it[1] - it[2]) ** 2)) for it in items) ** 0.5
        assert g_err <= grad_rtol * g_norm, (group, "gradient", g_err / g_norm)
        mean_norm = g_norm / len(items) ** 0.5
        for name, a, b, _, _ in items:
            err, own = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
            assert err <= TENSOR_GRAD_RTOL * max(own, mean_norm), (name, err, own, mean_norm)
        s_norm = sum(float(torch.sum(it[4] ** 2)) for it in items) ** 0.5
        s_err = sum(float(torch.sum((it[3] - it[4]) ** 2)) for it in items) ** 0.5
        assert s_err <= STEP_RTOL * s_norm, (group, "change", s_err / s_norm)


def assert_buffers(model, want):
    want = adaptive_from_jax(want)
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        err = float(np.abs(buf.numpy() - w).max())
        assert err <= STATS_RTOL * max(float(np.abs(w).max()), 1e-6), (name, err)


def test_adaptive_one_and_two_steps(sysu_dir):
    jm, variables = jax_variables(jad._init_probe, 31)
    reid, gen = jad._split(variables["params"])
    tx_reid, tx_gen = optax.adam(LR), optax.adam(LR)
    state = jad.AdaptiveState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              vq_stats=variables["vq_stats"], opt_reid=tx_reid.init(reid),
                              opt_gen=tx_gen.init(gen))
    step = jad.make_train_step(jm, tx_reid, tx_gen, K)
    model = ta.ModelAdaptive(class_num=CLASSES)
    model.load_state_dict(adaptive_from_jax(variables))
    ttx_reid, ttx_gen = schedules.adam(LR), schedules.adam(LR)
    tstate = tad.create_state(model, ttx_reid, ttx_gen)
    tstep = tad.make_train_step(model, ttx_reid, ttx_gen, K)

    def optimizer_of(name):
        return tstate.opt_reid if name.startswith("person_id.") else tstate.opt_gen

    for i, batch in enumerate(batches(sysu_dir, 2)):
        if i:
            sync(model, optimizer_of, (state.opt_reid[0], state.opt_gen[0]), state)
        want_before = jax_vars(state)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, (jm_metrics, j_rgb, j_ir) = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                                                jax.random.PRNGKey(0))
        tstate, (tm, rgb_fake, ir_fake) = tstep(tstate, {k: torch.from_numpy(v)
                                                         for k, v in batch.items()})
        assert set(tm) == set(jm_metrics) == {"mse", "latent", "id_fake", "kl_fake", "feat",
                                              "loss_gen", "loss_reid"}
        for k in jm_metrics:
            np.testing.assert_allclose(float(tm[k]), float(jm_metrics[k]), **METRIC_TOL,
                                       err_msg=k)
        np.testing.assert_allclose(rgb_fake.numpy(), np.asarray(j_rgb), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ir_fake.numpy(), np.asarray(j_ir), rtol=1e-4, atol=1e-5)
        assert_same_step(model, optimizer_of, (state.opt_reid[0], state.opt_gen[0]), before,
                         jax_vars(state), want_before)
        assert_buffers(model, jax_vars(state))
        assert tstate.step == int(state.step) == i + 1
    assert model.person_id.training and all(p.requires_grad for p in model.parameters())


def test_adaptive_loss_gen_rises_as_in_jax(sysu_dir):
    """Six steps of each side on one batch, from flax's own initialisation,
    each side on its own state: the ReID net sharpens on the real IR view
    (its loss falls tenfold), so the 100x KL of the fake view's scores to the
    real one's rises and carries ``loss_gen`` up while ``mse`` falls, in the
    JAX package as in the port; every metric of every step within
    ``SIX_STEP_RTOL`` of JAX's (``latent`` within ``SIX_STEP_LATENT_RTOL``)."""
    jm = ja.ModelAdaptive(class_num=CLASSES)
    variables = host(jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *HW, 3)), method=jad._init_probe))())
    reid, gen = jad._split(variables["params"])
    tx_reid, tx_gen = optax.adam(LR), optax.adam(LR)
    state = jad.AdaptiveState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              vq_stats=variables["vq_stats"], opt_reid=tx_reid.init(reid),
                              opt_gen=tx_gen.init(gen))
    step = jad.make_train_step(jm, tx_reid, tx_gen, K)
    model = ta.ModelAdaptive(class_num=CLASSES)
    model.load_state_dict(adaptive_from_jax(variables))
    ttx_reid, ttx_gen = schedules.adam(LR), schedules.adam(LR)
    tstate = tad.create_state(model, ttx_reid, ttx_gen)
    tstep = tad.make_train_step(model, ttx_reid, ttx_gen, K)
    batch = batches(sysu_dir, 1)[0]
    got, want = {}, {}
    for _ in range(6):
        state, (jm_metrics, _, _) = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                                         jax.random.PRNGKey(0))
        tstate, (tm, _, _) = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in jm_metrics:
            want.setdefault(k, []).append(float(jm_metrics[k]))
            got.setdefault(k, []).append(float(tm[k]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   rtol=SIX_STEP_LATENT_RTOL if k == "latent" else SIX_STEP_RTOL)
    for side in (want, got):
        rise = side["loss_gen"][-1] - side["loss_gen"][0]
        assert side["loss_gen"][-1] > 2 * side["loss_gen"][0], side["loss_gen"]
        assert side["kl_fake"][-1] - side["kl_fake"][0] >= 0.5 * rise, side["kl_fake"]
        assert side["loss_reid"][-1] < 0.1 * side["loss_reid"][0], side["loss_reid"]
        assert side["mse"][-1] < side["mse"][0], side["mse"]


def test_other_instance_ids_bit_equal():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for batch_ids, num_pos in ((4, 4), (2, 2), (3, 5)):
            got = tg2c.other_instance_ids(batch_ids, num_pos, a)
            want = jg2c.other_instance_ids(batch_ids, num_pos, b)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            # another instance of the same identity, never the anchor itself
            assert np.all(got // num_pos == np.arange(len(got)) // num_pos)
            assert np.all(got != np.arange(len(got)))


def test_gray2color_one_and_two_steps(sysu_dir):
    jm, variables = jax_variables(jg2c._init_probe, 41)
    tx = optax.adam(LR)
    state = jg2c.G2CState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"], vq_stats=variables["vq_stats"],
                          opt_state=tx.init(variables["params"]))
    step = jg2c.make_train_step(jm, tx)
    model = ta.ModelAdaptive(class_num=CLASSES, ir_head=False)
    model.load_state_dict(adaptive_from_jax(variables))
    ttx = schedules.adam(LR)
    tstate = TrainState(step=0, model=model.train(), optimizer=ttx.build(model.parameters()))
    tstep = tg2c.make_train_step(model, ttx)
    rng = np.random.default_rng(5)
    for i, batch in enumerate(batches(sysu_dir, 2)):
        if i:
            sync(model, lambda name: tstate.optimizer, (state.opt_state[0],), state)
        ids = tg2c.other_instance_ids(P, K, rng)
        want_before = jax_vars(state)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, (jm_metrics, j_images) = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                                             jnp.asarray(ids), jax.random.PRNGKey(0))
        tstate, (tm, images) = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.from_numpy(ids))
        assert set(tm) == set(jm_metrics) == {"loss", "recon", "recon_feat", "latent"}
        for k in jm_metrics:
            np.testing.assert_allclose(float(tm[k]), float(jm_metrics[k]), **FUSED_METRIC_TOL,
                                       err_msg=k)
        for got, want in zip(images, j_images):
            assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= FUSED_RTOL * float(
                np.abs(np.asarray(want)).max())
        assert_same_step(model, lambda name: tstate.optimizer, (state.opt_state[0],), before,
                         jax_vars(state), want_before, grad_rtol=FUSED_RTOL)
        assert_buffers(model, jax_vars(state))
        assert tstate.step == int(state.step) == i + 1


def test_command_lines_on_the_cpu(tmp_path):
    """Both trainers for two steps on a 64x32 tree, with ``--sched cycle``,
    sample grids, metrics and checkpoints; gray2color once more by
    ``--resume``."""
    data = jreid.make_synthetic_sysu(str(tmp_path / "blobs"), n_ids=4, per_id=4, h=64, w=32)
    common = ["--path", data, "--device", "cpu", "--batch_size", "2", "--num_pos", "2",
              "--log_every", "1", "--sched", "cycle", "--sample_every", "2"]
    m = tad.main(common + ["--steps", "2", "--sample_dir", str(tmp_path / "sa"),
                           "--metrics_csv", str(tmp_path / "a.csv"),
                           "--ckpt_dir", str(tmp_path / "ca")])
    assert np.isfinite(m["mse"]) and os.path.exists(str(tmp_path / "sa" / "00002.png"))
    saved = torch.load(str(tmp_path / "ca" / "last.pt"), weights_only=True)
    assert saved["step"] == 2 and "adaptor.dec_ir.blocks.0.weight" in saved["model"]

    g = tg2c.main(common + ["--steps", "2", "--sample_dir", str(tmp_path / "sg"),
                            "--metrics_csv", str(tmp_path / "g.csv"),
                            "--ckpt_dir", str(tmp_path / "cg"), "--save_every", "2"])
    assert np.isfinite(g["loss"]) and os.path.exists(str(tmp_path / "sg" / "00002.png"))
    saved = torch.load(str(tmp_path / "cg" / "last.pt"), weights_only=True)
    assert saved["step"] == 2 and not any(k.startswith("adaptor.dec_ir.") for k in saved["model"])
    tg2c.main(common + ["--steps", "1", "--ckpt_dir", str(tmp_path / "cg"), "--resume"])
    assert torch.load(str(tmp_path / "cg" / "last.pt"), weights_only=True)["step"] == 3
    for name, rows in (("a.csv", 2), ("g.csv", 2)):
        with open(str(tmp_path / name)) as f:
            assert len(f.read().strip().splitlines()) == rows + 1


@pytest.mark.parametrize("trainer", [tad, tg2c], ids=["adaptive", "gray2color"])
def test_the_default_device_is_the_card(tmp_path, trainer):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert trainer.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        trainer.main(["--synthetic", "--steps", "1", "--ckpt_dir", str(tmp_path / "ck")])
    assert os.listdir(str(tmp_path)) == []
