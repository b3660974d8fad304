"""The port's ``train/stargan_bi.py`` against the JAX package's: ``adv_loss``,
and two steps of ``make_train_step`` from the same weights and batch, the
first updating the discriminator and the second masked by ``d_every``
(``d_mask`` 0), the second from the JAX side's state after the first: every
loss (R1 among them), the ReID net's batch-norm statistics after the step
(the ReID step's; the generator step's train-mode pass moves them and they
are put back), the ReID optimizer's momentum (optax's trace: plain Nesterov
SGD), both Adams' first moments, and on the masked step the discriminator's
parameters and Adam state left as they were on both sides.  Then the
identity-preservation eval and the sample grid against the JAX package's,
the command line on the CPU, and the default device.

Model: ``ModelStarGAN`` (resnet18, four identities) on 64x64 images, P = K =
2, with ``img_size`` an int of 64 whose ``2 ** 14 // img_size`` is 16
(``Narrow``): the generators and the discriminator keep their depth and
geometry at 64 but start 16 channels wide instead of 256 (the same object on
both sides).  Seeded weights carried across by ``stargan_from_jax``.

The ReID net's gradient at this toy size is ill-conditioned: in float64
an input noise of 1e-6 moves the generator's gradient, which flows back
through that net's train-mode batch norms and ReLU / max-pool kinks, by 1.2 %
of its norm; from the same weights the port's fp32 gradient lies 1.5 % and
the JAX package's 1.2 % from the port's float64 one.  Hence, from the same
weights (``make_loss_fns``): the losses rtol 1e-4 / atol 1e-5, the
generator's gradient within 5e-2 of its norm, the ReID net's within 3e-2.
In the whole step the ReID step first moves its weights by 0.1 times that
gradient, and the generator's terms through the moved net differ by up to
0.5 % (``id_ir``, measured; tolerance 2e-2, the other losses 1e-4) and its
gradient by 16 % of its norm (tolerance 3e-1; the discriminator's, whose
inputs the ReID net does not touch, 1e-2; the ReID net's 3e-2), each
tensor's within 1e-1 of its own norm or of the group's mean norm a tensor
except the generator's (3e-1); the port's change is its optimizer's rule on
its own state; statistics within 1e-4 of their largest element.  The
identity-preservation features within 1e-4 of their largest element, the
mAP within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vqvae2_tpu.models.stargan as js
from vqvae2_tpu.train import reid as jreid
from vqvae2_tpu.train import stargan_bi as jsb
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.models import stargan as ts
from vqvae2_tpu_torch.train import stargan_bi as tsb
from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import stargan_from_jax

HW = (64, 64)
P, K = 2, 2
CLASSES = 4
LR, LR_DISC, LR_F = 1e-4, 1e-4, 0.1
WIDTH = 16
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
# the generator's terms that pass through the ReID net after its SGD step
AFTER_REID = ("id_ir", "feat_ir", "hinge_pos", "loss_gen")
AFTER_REID_TOL = dict(rtol=2e-2, atol=1e-5)
GRAD_RTOL = {"reid": 3e-2, "gen": 3e-1, "disc": 1e-2}
GEN_GRAD_RTOL = 5e-2
TENSOR_GRAD_RTOL = 1e-1
STATS_RTOL = 1e-4


class Narrow(int):
    """``img_size`` 64 whose hourglass starts ``WIDTH`` channels wide."""

    def __rfloordiv__(self, other):
        return WIDTH


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
        if leaf == "var":
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "bias") or leaf.endswith("_bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf == "scale" or leaf.endswith("_scale"):
            return (1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_shapes(jm, n):
    """What the JAX trainer's ``init_probe`` creates (its lines)."""
    probe = jnp.zeros((n, *HW, 3), jnp.float32)

    def init_probe(module):
        feat, *_ = module.person_id(xRGB=probe, xIR=probe, modal=0, with_feature=True)
        fv, fi = jnp.split(feat, 2, axis=0)
        module.gen_1(probe, fi)
        module.gen_2(probe, fv)
        return module.discriminate(probe, jnp.zeros((probe.shape[0],), jnp.int32))

    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                           "dropout": jax.random.PRNGKey(1)},
                                          method=init_probe))


@pytest.fixture(scope="module")
def sysu_dir(tmp_path_factory):
    return jreid.make_synthetic_sysu(str(tmp_path_factory.mktemp("sysu")), n_ids=CLASSES,
                                     per_id=4, h=HW[0], w=HW[1])


def batches(sysu_dir, n, seed=5):
    ds = tsysu.SYSUData(sysu_dir, part=False, seed=0)
    ds.samplize(P, K)
    it = tds.epoch_row_batches(ds, P * K)
    rng = np.random.default_rng(seed)
    out = [tbi.cross_modal_batch(next(it), rng, "cpu") for _ in range(n)]
    it.close()
    return out


@pytest.fixture(scope="module")
def both():
    jm = js.ModelStarGAN(class_num=CLASSES, img_size=Narrow(64))
    variables = seeded(init_shapes(jm, 2 * K), 51)
    model = ts.ModelStarGAN(class_num=CLASSES, img_size=Narrow(64))
    assert model.adaptor1.from_rgb.out_channels == WIDTH
    model.load_state_dict(stargan_from_jax(variables))
    return jm, variables, model


def test_adv_loss():
    x = np.random.default_rng(0).normal(size=(7,)).astype(np.float32) * 4
    for t in (0, 1):
        np.testing.assert_allclose(float(tsb.adv_loss(torch.from_numpy(x), t)),
                                   float(jsb.adv_loss(jnp.asarray(x), t)), rtol=1e-6)


def jax_vars(state):
    return host({"params": state.params, "batch_stats": state.batch_stats})


def jax_moments(state):
    """``{port name: (group, first moment, second moment)}`` and the two Adam
    counts."""
    out = {}
    trace = stargan_from_jax({"params": host(state.opt_reid[0].trace)})
    out.update({n: ("reid", m, None) for n, m in trace.items()})
    counts = {}
    for group, opt in (("gen", state.opt_gen), ("disc", state.opt_disc)):
        mu, nu = (stargan_from_jax({"params": host(t)}) for t in (opt[0].mu, opt[0].nu))
        out.update({n: (group, mu[n], nu[n]) for n in mu})
        counts[group] = int(opt[0].count)
    return out, counts


def group_of(name):
    return ("reid" if name.startswith("person_id.") else
            "disc" if name.startswith("discriminator.") else "gen")


def optimizer(tstate, group):
    return {"reid": tstate.opt_reid, "gen": tstate.opt_gen, "disc": tstate.opt_disc}[group]


def sync(model, tstate, state):
    model.load_state_dict(stargan_from_jax(jax_vars(state)))
    moments, counts = jax_moments(state)
    for name, p in model.named_parameters():
        group, m, v = moments[name]
        if group == "reid":
            tstate.opt_reid.state[p] = {"momentum_buffer": m.clone()}
        elif counts[group]:
            optimizer(tstate, group).state[p] = {"step": torch.tensor(float(counts[group])),
                                                 "exp_avg": m.clone(), "exp_avg_sq": v.clone()}


def adam_change(m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    return -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def assert_same_step(model, tstate, state, before, masked=False):
    moments, counts = jax_moments(state)
    got = model.state_dict()
    groups = {}
    for name, p in model.named_parameters():
        group, m_want, _ = moments[name]
        assert group == group_of(name), name
        st = optimizer(tstate, group).state[p]
        d_got = (got[name] - before[name]).double()
        ulp = torch.finfo(torch.float32).eps * before[name].double().abs()
        if group == "reid":
            m_got = st["momentum_buffer"].double()
            g = p.grad.double()
            rule = -LR_F * (g + 0.9 * m_got)
            ulp = ulp + 4 * torch.finfo(torch.float32).eps * LR_F * (g.abs() + 0.9 * m_got.abs())
        elif group == "disc" and masked:
            m_got = st["exp_avg"].double()
            rule = torch.zeros_like(d_got)
        else:
            m_got = st["exp_avg"].double()
            assert int(st["step"]) == counts[group], name
            rule = adam_change(m_got, st["exp_avg_sq"].double(), counts[group],
                               LR if group == "gen" else LR_DISC)
        assert bool(torch.all((d_got - rule).abs() <= 1e-4 * rule.abs() + ulp + 1e-12)), name
        groups.setdefault(group, []).append((name, m_got, m_want.double()))
    assert sorted(groups) == ["disc", "gen", "reid"]
    for group, items in groups.items():
        g_norm = sum(float(torch.sum(it[2] ** 2)) for it in items) ** 0.5
        g_err = sum(float(torch.sum((it[1] - it[2]) ** 2)) for it in items) ** 0.5
        assert g_err <= GRAD_RTOL[group] * g_norm, (group, g_err / g_norm)
        mean_norm = g_norm / len(items) ** 0.5
        for name, a, b in items:
            err, own = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
            tol = GRAD_RTOL["gen"] if group == "gen" else TENSOR_GRAD_RTOL
            assert err <= tol * max(own, mean_norm), (name, err, own, mean_norm)


def assert_buffers(model, want):
    want = stargan_from_jax(want)
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        err = float(np.abs(buf.numpy() - w).max())
        assert err <= STATS_RTOL * max(float(np.abs(w).max()), 1e-6), (name, err)


def test_two_steps_the_second_with_d_masked(sysu_dir, both):
    jm, variables, model = both
    model.load_state_dict(stargan_from_jax(variables))
    reid, gen, disc = jsb._split(variables["params"])
    tx_reid = optax.sgd(LR_F, momentum=0.9, nesterov=True)
    tx_gen, tx_disc = optax.adam(LR), optax.adam(LR_DISC)
    state = jsb.GanState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_reid=tx_reid.init(reid),
                         opt_gen=tx_gen.init(gen), opt_disc=tx_disc.init(disc))
    step = jsb.make_train_step(jm, tx_reid, tx_gen, tx_disc, K)
    ttx_reid = schedules.SGDSchedule(LR_F)
    ttx_gen, ttx_disc = schedules.adam(LR), schedules.adam(LR_DISC)
    tstate = tsb.create_state(model, ttx_reid, ttx_gen, ttx_disc)
    tstep = tsb.make_train_step(model, ttx_reid, ttx_gen, ttx_disc, K)
    for i, batch in enumerate(batches(sysu_dir, 2)):
        knobs = {"r1_weight": 1.0, "adv_weight": 0.5, "d_mask": 1.0 - i}
        if i:
            sync(model, tstate, state)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        disc_state = {p: {k: v.clone() for k, v in tstate.opt_disc.state[p].items()}
                      for p in model.discriminator.parameters()} if i else None
        want_disc = host(state.params["discriminator"]), host(state.opt_disc)
        state, jm_metrics = step(state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
                                 jax.random.PRNGKey(0),
                                 {k: jnp.float32(v) for k, v in knobs.items()})
        tstate, tm = tstep(tstate, batch, knobs)
        assert set(tm) == set(jm_metrics) == {
            "cycle", "id_ir", "feat_ir", "g_adv", "hinge_pos", "hinge_neg", "loss_reid",
            "loss_gen", "loss_disc", "d_real", "d_fake", "r1"}
        assert float(tm["r1"]) > 0
        for k in jm_metrics:
            tol = AFTER_REID_TOL if k in AFTER_REID else METRIC_TOL
            np.testing.assert_allclose(float(tm[k]), float(jm_metrics[k]), **tol,
                                       err_msg=f"step {i}: {k}")
        assert_buffers(model, jax_vars(state))
        if i:                           # masked: D and its Adam as they were
            same = jax.tree_util.tree_map(np.array_equal, want_disc,
                                          (host(state.params["discriminator"]),
                                           host(state.opt_disc)))
            assert all(jax.tree_util.tree_leaves(same))
            for name, p in model.discriminator.named_parameters():
                assert torch.equal(p, before[f"discriminator.{name}"]), name
                assert all(torch.equal(v, disc_state[p][k])
                           for k, v in tstate.opt_disc.state[p].items()), name
        assert_same_step(model, tstate, state, before, masked=bool(i))
        assert tstate.step == int(state.step) == i + 1


def test_the_loss_functions_from_the_same_weights(sysu_dir, both):
    """The ReID and the generator objectives from the same weights, styles
    and batch: losses, metrics and gradients."""
    from vqvae2_tpu_torch.models.adaptive import frozen

    jm, variables, model = both
    model.load_state_dict(stargan_from_jax(variables))
    batch = batches(sysu_dir, 1)[0]
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    reid, gen, disc = jsb._split(variables["params"])
    cols = {"batch_stats": variables["batch_stats"]}
    j_reid, j_gen, _ = jsb.make_loss_fns(jm, K)
    t_reid, t_gen, _ = tsb.make_loss_fns(model, K)

    (jl, (jfeat, _)), jg = jax.jit(jax.value_and_grad(j_reid, has_aux=True))(
        reid, {**gen, **disc}, cols, jb, jax.random.PRNGKey(0))
    model.zero_grad(set_to_none=True)
    tl, tfeat = t_reid(batch)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **METRIC_TOL)
    np.testing.assert_allclose(tfeat.detach().numpy(), np.asarray(jfeat), rtol=1e-4, atol=1e-4)
    want = stargan_from_jax({"params": host(jg)})
    got = {f"person_id.{n}": p.grad for n, p in model.person_id.named_parameters()
           if p.grad is not None}
    err = sum(float(((got[n] - want[n]) ** 2).sum()) for n in got) ** 0.5
    assert set(want) - set(got) <= {n for n in want if ".z_module." in n}
    assert err <= GRAD_RTOL["reid"] * sum(float((w ** 2).sum()) for w in want.values()) ** 0.5

    featV, featI = np.split(np.array(jfeat), 2)
    (jl, (jmet, _, _)), jg = jax.jit(jax.value_and_grad(j_gen, has_aux=True))(
        gen, {**reid, **disc}, cols, jb, featV, featI, 0.5, jax.random.PRNGKey(0))
    model.load_state_dict(stargan_from_jax(variables))
    model.zero_grad(set_to_none=True)
    with frozen(model.person_id), frozen(model.discriminator):
        tl, tmet, _, _ = t_gen(batch, torch.from_numpy(featV), torch.from_numpy(featI), 0.5)
        tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **METRIC_TOL)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **METRIC_TOL, err_msg=k)
    want = stargan_from_jax({"params": host(jg)})
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert set(got) <= set(want) and not any(n.startswith(("person_id.", "discriminator."))
                                              for n in got)
    err = sum(float(((got.get(n, torch.zeros_like(w)) - w) ** 2).sum())
              for n, w in want.items()) ** 0.5
    assert err <= GEN_GRAD_RTOL * sum(float((w ** 2).sum()) for w in want.values()) ** 0.5


def test_the_generator_step_puts_the_reid_statistics_back(sysu_dir, both):
    """The ReID net runs twice in train mode (its own step, then on the
    translations); only the first pass's statistics stay."""
    import copy

    _, variables, model = both
    model.load_state_dict(stargan_from_jax(variables))
    twin = copy.deepcopy(model)
    batch = batches(sysu_dir, 1)[0]
    seen = []
    handle = model.person_id.register_forward_hook(lambda m, a, out: seen.append(m.training))
    zero = schedules.adam(0.0)
    state = tsb.create_state(model, schedules.SGDSchedule(0.0), zero, zero)
    try:
        tsb.make_train_step(model, schedules.SGDSchedule(0.0), zero, zero, K)(state, batch)
    finally:
        handle.remove()
    assert seen == [True, True]
    with torch.no_grad():
        twin.person_id(xRGB=batch["aug_rgb"], xIR=batch["aug_ir"], modal=0, with_feature=True)
    for (name, a), b in zip(model.person_id.named_buffers(), twin.person_id.buffers()):
        assert torch.equal(a, b), name


def test_idpres_eval_and_sample_fn(sysu_dir, both):
    jm, variables, model = both
    model.load_state_dict(stargan_from_jax(variables))
    ds = tsysu.SYSUData(sysu_dir, part=False, seed=0)
    sets = tsb.build_idpres_set(ds, seed=3, trials=2)
    from vqvae2_tpu.data.sysu import SYSUData as JSYSU

    want_sets = jsb.build_idpres_set(JSYSU(sysu_dir, part=False, seed=0), seed=3, trials=2)
    for got, want in zip(sets, want_sets):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    jstate = jsb.GanState(step=0, params=variables["params"],
                          batch_stats=variables["batch_stats"], opt_reid=None, opt_gen=None,
                          opt_disc=None)
    want = jsb.make_idpres_eval(jm)(jstate, want_sets)
    got = tsb.make_idpres_eval(model)(sets)
    assert 0.0 <= got <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-6)
    batch = batches(sysu_dir, 1)[0]
    want = jsb.make_sample_fn(jm)(variables["params"], variables["batch_stats"],
                                  {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    for g, w in zip(tsb.make_sample_fn(model)(batch), want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_main_on_the_cpu(tmp_path, monkeypatch):
    """Two steps through the command line on a 64x64 tree with the
    discriminator every other step, a sample grid, an identity-preservation
    eval and checkpoints (the best by that mAP); a third by ``--resume``."""
    monkeypatch.setattr(tsb, "_generator_img_size", lambda h, w: Narrow(64))
    data = jreid.make_synthetic_sysu(str(tmp_path / "blobs"), n_ids=4, per_id=4, h=64, w=64)
    csv, ckpt, samples = (str(tmp_path / n) for n in ("m.csv", "ck", "s"))
    common = ["--path", data, "--device", "cpu", "--batch_size", "2", "--num_pos", "2",
              "--log_every", "1", "--metrics_csv", csv, "--ckpt_dir", ckpt, "--d_every", "2"]
    m = tsb.main(common + ["--steps", "2", "--sample_dir", samples, "--sample_every", "2",
                           "--eval_every", "2", "--idpres_trials", "2"])
    assert np.isfinite(m["loss_disc"]) and m["r1"] > 0 and 0.0 <= m["idpres_map"] <= 1.0
    assert os.path.exists(os.path.join(samples, "00002.png"))
    assert os.path.exists(os.path.join(ckpt, "best.pt"))
    saved = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
    assert saved["step"] == 2 and sorted(saved) == ["model", "opt_disc", "opt_gen", "opt_reid",
                                                   "step"]
    os.replace(os.path.join(ckpt, "last.pt"), os.path.join(ckpt, "step_0000002.pt"))
    tsb.main(common + ["--steps", "1", "--resume"])
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 3


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert tsb.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsb.main(["--synthetic", "--steps", "1", "--ckpt_dir", str(tmp_path / "ck")])
    assert os.listdir(str(tmp_path)) == []
