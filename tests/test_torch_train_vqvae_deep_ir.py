"""The port's ``train/vqvae_deep_ir.py`` against the JAX package's: a
reconstruction step, then two full steps (``gen_inter``, the ReID step, the
generator step), each from the JAX side's state after the one before
(parameters, statistics, codebooks, both Adams' moments and counts): every
loss, the codebooks (two EMA steps a full step) and the batch-norm
statistics after the step (the fusions' move in ``gen_inter`` and again in
the generator step, the ReID net's in ``gen_inter`` and the ReID step), and
each Adam's first moment; the sample grid's two eval-mode passes; the
command line through both stages on the CPU, and the default device.

Model: ``ModelAdaptive_Deep`` (resnet18, four identities, ``style_dim`` 16)
on a narrowed ``VQVAE_Deep`` (channel 16, one residual block of 8,
``embed_dim`` 8, 16 codes), patched in on both sides; images 64x32, P = K =
2; seeded weights carried across by ``adaptive_deep_from_jax``; the batches
built by the port's ``cross_modal_batch``.

Tolerances: the losses rtol 1e-4 / atol 1e-5, but 5e-4 for the full
step's generator terms (measured 1.1e-4): they follow the ReID step, whose
Adam moves each weight by about ``lr * sign(g)``, so the weights whose
gradient lies within the rounding noise move either way on the two sides,
and the generator's losses pass through that ReID net.  Statistics and
codebooks within 1e-4 of their largest element after the reconstruction
step, 1e-3 after a full step (measured 6.2e-4 and 8.7e-5): the generator
step's codebook update quantizes contents fused with that ReID net's
features.  Each optimizer's first
moment as one vector within 3e-2 of its norm (measured 1.4e-2 for the
generator, whose gradient flows back through the ReID net: at this toy size
that net's gradient moves by 1-2 % under input noise of 1e-5,
``test_torch_train_vqvae_deep_bi``), each tensor's within 1e-1 of its own
norm or of the group's mean norm a tensor; the port's change is optax's
update from the port's moments, the two sides' changes within 3e-1 of their
norm; the sample grid's images within 1e-4 of their largest element.
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
from vqvae2_tpu.train import vqvae_deep as jtd
from vqvae2_tpu.train import vqvae_deep_ir as jir
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.models import adaptive as ta
from vqvae2_tpu_torch.train import adaptive as tta
from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
from vqvae2_tpu_torch.train import vqvae_deep_ir as tir
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import adaptive_deep_from_jax

HW = (64, 32)
P, K = 2, 2
CLASSES = 4
LR = 3e-4
FEAT_DIM = 512
NARROW = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
GEN_METRIC_TOL = dict(rtol=5e-4, atol=1e-5)
GRAD_RTOL = {"reid": 3e-2, "gen": 3e-2}
TENSOR_GRAD_RTOL = 1e-1
STEP_RTOL = 3e-1
STATS_RTOL = (1e-4, 1e-3)


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


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(ja, "VQVAE_Deep", functools.partial(ja.VQVAE_Deep, **NARROW))
    monkeypatch.setattr(ta, "VQVAE_Deep", functools.partial(ta.VQVAE_Deep, **NARROW))


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


def jax_vars(state):
    return host({"params": state.params, "batch_stats": state.batch_stats,
                 "vq_stats": state.vq_stats})


def jax_moments(state):
    """Both Adams' counts and moments as port ``state_dict`` names."""
    reid, gen = state.opt_reid[0], state.opt_gen[0]
    moments = [adaptive_deep_from_jax({"params": host({**m_gen, **m_reid})})
               for m_gen, m_reid in ((gen.mu, reid.mu), (gen.nu, reid.nu))]
    return int(reid.count), int(gen.count), moments[0], moments[1]


def sync(model, tstate, state):
    model.load_state_dict(adaptive_deep_from_jax(jax_vars(state)))
    n_reid, n_gen, mu, nu = jax_moments(state)
    for name, p in model.named_parameters():
        reid = name.startswith("person_id.")
        opt, n = (tstate.opt_reid, n_reid) if reid else (tstate.opt_gen, n_gen)
        if n:
            opt.state[p] = {"step": torch.tensor(float(n)), "exp_avg": mu[name].clone(),
                            "exp_avg_sq": nu[name].clone()}


def adam_change(m, v, t, lr=LR, b1=0.9, b2=0.999, eps=1e-8):
    return -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def assert_same_step(model, tstate, state, before, want_before):
    n_reid, n_gen, mu, nu = jax_moments(state)
    want = adaptive_deep_from_jax(jax_vars(state))
    want_before = adaptive_deep_from_jax(want_before)
    got = model.state_dict()
    groups = {}
    for name, p in model.named_parameters():
        reid = name.startswith("person_id.")
        opt, t = (tstate.opt_reid, n_reid) if reid else (tstate.opt_gen, n_gen)
        st = opt.state.get(p, {})
        assert ("exp_avg" in st) == (t > 0), name
        assert int(st.get("step", 0)) == t, name
        m_got = st.get("exp_avg", torch.zeros_like(p)).double()
        d_got = (got[name] - before[name]).double()
        if t:
            rule = adam_change(m_got, st["exp_avg_sq"].double(), t)
            ulp = torch.finfo(torch.float32).eps * before[name].double().abs()
            assert bool(torch.all((d_got - rule).abs() <= 1e-4 * rule.abs() + ulp + 1e-12)), name
        groups.setdefault("reid" if reid else "gen", []).append(
            (name, m_got, mu[name].double(), d_got, (want[name] - want_before[name]).double()))
    for group, items in groups.items():
        norm2 = lambda k: sum(float(torch.sum(it[k] ** 2)) for it in items)   # noqa: E731
        g_norm = norm2(2) ** 0.5
        if g_norm == 0:                  # the ReID net before its first step
            assert all(float(it[1].abs().max()) == 0 for it in items)
            continue
        g_err = sum(float(torch.sum((it[1] - it[2]) ** 2)) for it in items) ** 0.5
        assert g_err <= GRAD_RTOL[group] * g_norm, (group, "gradient", g_err / g_norm)
        mean_norm = g_norm / len(items) ** 0.5
        for name, a, b, _, _ in items:
            err, own = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
            assert err <= TENSOR_GRAD_RTOL * max(own, mean_norm), (name, err, own, mean_norm)
        s_err = sum(float(torch.sum((it[3] - it[4]) ** 2)) for it in items) ** 0.5
        assert s_err <= STEP_RTOL * norm2(4) ** 0.5, (group, "change", s_err / norm2(4) ** 0.5)


def assert_buffers(model, want, rtol):
    want = adaptive_deep_from_jax(want)
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        err = float(np.abs(buf.numpy() - w).max()) / max(float(np.abs(w).max()), 1e-6)
        assert err <= rtol, (name, err)


@pytest.fixture
def both(narrow):
    jm = ja.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *HW, 3)), method=jm.init_probe))
    variables = seeded(shapes, 41)
    model = ta.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    model.load_state_dict(adaptive_deep_from_jax(variables))
    return jm, variables, model


def test_recon_then_two_full_steps(sysu_dir, both):
    jm, variables, model = both
    reid, gen = jtd._split_params(variables["params"])
    tx_reid, tx_gen = optax.adam(LR), optax.adam(LR)
    state = jtd.DeepState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"], vq_stats=variables["vq_stats"],
                          opt_reid=tx_reid.init(reid), opt_gen=tx_gen.init(gen))
    jsteps = [jir.make_recon_step(jm, tx_gen, FEAT_DIM), jir.make_full_step(jm, tx_reid, tx_gen, K)]
    ttx_reid, ttx_gen = schedules.adam(LR), schedules.adam(LR)
    tstate = tta.create_state(model, ttx_reid, ttx_gen)
    tsteps = [tir.make_recon_step(model, ttx_gen, FEAT_DIM),
              tir.make_full_step(model, ttx_reid, ttx_gen, K)]
    keys = [{"recon", "latent", "loss_gen", "loss_reid"},
            {"latent", "id_ir", "feat_ir", "disc_fake", "loss_gen", "recon", "loss_reid"}]
    for i, batch in enumerate(batches(sysu_dir, 3)):
        kind = min(i, 1)
        if i:
            sync(model, tstate, state)
        want_before = jax_vars(state)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, jm_metrics = jsteps[kind](state, {k: jnp.asarray(v.numpy())
                                                 for k, v in batch.items()},
                                         jax.random.PRNGKey(0))
        tstate, tm = tsteps[kind](tstate, batch)
        assert set(tm) == set(jm_metrics) == keys[kind]
        for k in jm_metrics:
            tol = GEN_METRIC_TOL if kind and k not in ("loss_reid", "recon") else METRIC_TOL
            np.testing.assert_allclose(float(tm[k]), float(jm_metrics[k]), **tol,
                                       err_msg=f"step {i}: {k}")
        assert_same_step(model, tstate, state, before, want_before)
        assert_buffers(model, jax_vars(state), STATS_RTOL[kind])
        assert tstate.step == int(state.step) == i + 1
    assert all(p.requires_grad for p in model.parameters()) and model.person_id.training


def test_the_recon_step_moves_every_generator_moment(sysu_dir, both):
    """optax updates every leaf: after a reconstruction step the fusions'
    and the discriminator's Adam states exist (zero moments, count 1), so the
    full steps that follow correct their bias from the same count."""
    _, _, model = both
    tx = schedules.adam(LR)
    tstate = tta.create_state(model, tx, tx)
    tir.make_recon_step(model, tx, FEAT_DIM)(tstate, batches(sysu_dir, 1)[0])
    for name, p in model.named_parameters():
        st = tstate.opt_gen.state.get(p) if not name.startswith("person_id.") else None
        if st is None:
            assert name.startswith("person_id.") and p not in tstate.opt_reid.state
            continue
        assert int(st["step"]) == 1, name
        if name.startswith(("fusion", "resblocks", "discriminator")):
            assert float(st["exp_avg"].abs().max()) == 0.0, name


def test_sample_fn(sysu_dir, both):
    jm, variables, model = both
    batch = batches(sysu_dir, 1)[0]
    want = jir.make_sample_fn(jm, FEAT_DIM)(variables["params"], variables["batch_stats"],
                                            variables["vq_stats"],
                                            {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = tir.make_sample_fn(model, FEAT_DIM)(batch)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * float(np.abs(w).max())
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_main_through_both_stages(tmp_path, narrow):
    """One reconstruction and two full steps through the command line on a
    64x32 tree, with a sample grid and checkpoints."""
    data = jreid.make_synthetic_sysu(str(tmp_path / "blobs"), n_ids=4, per_id=4, h=64, w=32)
    csv, ckpt, samples = (str(tmp_path / n) for n in ("m.csv", "ck", "s"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tir, "build_model", lambda args, n, device: ta.ModelAdaptive_Deep(
            class_num=n, arch=args.arch, style_dim=16).to(device))
        m = tir.main(["--path", data, "--device", "cpu", "--batch_size", "2", "--num_pos", "2",
                      "--steps", "3", "--stage_reconstruction", "1", "--log_every", "1",
                      "--metrics_csv", csv, "--ckpt_dir", ckpt, "--sample_dir", samples,
                      "--sample_every", "3"])
    assert np.isfinite(m["loss_gen"]) and m["loss_reid"] > 0 and m["recon"] == 0.0
    assert os.path.exists(os.path.join(samples, "00003.png"))
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 3
    with open(csv) as f:
        lines = f.read().strip().splitlines()
    cols = lines[0].split(",")
    assert len(lines) == 4 and float(lines[1].split(",")[cols.index("loss_reid")]) == 0.0


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert tir.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        tir.main(["--synthetic", "--steps", "1", "--ckpt_dir", str(tmp_path / "ck")])
    assert os.listdir(str(tmp_path)) == []
