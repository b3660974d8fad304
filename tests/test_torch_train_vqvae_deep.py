"""The port's ``train/vqvae_deep.py`` against the JAX package's:
``threshold_up_mask`` (``jnp.median`` of an even count is the mean of the two
middle values; the x16 bilinear resize is ``jax.image.resize``'s),
``random_gray`` on the same weights, and one and two steps of
``make_train_step`` from the same weights and batch: every loss, every
parameter (the ReID net after its own Adam step, the generator after its
own), the batch-norm statistics, the spectral norms' ``u`` and ``sigma``, and
the codebooks.  Then the command line on the CPU (a sample grid, a
validation, checkpoints, ``--resume``) and the default device.

Model: ``ModelAdaptive_Deep`` (resnet18, four identities) on a narrowed
``VQVAE_Deep`` (channel 16, one residual block of 8, ``embed_dim`` 8, 16
codes), patched in on both sides, with ``style_dim`` 16; images 64x32, P = K
= 2.  Seeded weights carried across by ``adaptive_deep_from_jax``.  The gray
mix is pinned on both sides to the same numpy weights (the two libraries draw
different numbers).

Tolerances: the losses rtol 1e-4 / atol 1e-5.  The second step starts from
the JAX side's state after the first (parameters, statistics, codebooks,
Adam's moments), so both steps are held from the same start.  Each
optimizer's gradient (Adam's first moment), as one vector, within 1e-2 of its
norm, each tensor's within 1e-1 of its own norm or of the group's mean norm a
tensor: the ReID net's train-mode batch norms over four rows make its fp32
gradient ill-conditioned (against a float64 backward of the port, 3.7e-3 of
the norm for the port's and 3.4e-3 for the JAX package's; the two differ by
6e-3).  The port's parameter change is optax's update from the port's own
moments (rtol 1e-4, plus an fp32 ulp of the parameter).  The two sides'
changes within 3e-1 of their norm: Adam's first steps move each weight by
about ``lr * sign(g)``, so the elements whose gradient lies within the
rounding noise move either way (measured: 6e-2 for the ReID net, 1.9e-1 for
the generator, mostly its AdaIN dense layers, whose small gradients are sums
that cancel).  Statistics and codebooks within 1e-4 of their largest element.
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
from vqvae2_tpu_torch.data import datasets as tds
from vqvae2_tpu_torch.data import sysu as tsysu
from vqvae2_tpu_torch.models import adaptive as ta
from vqvae2_tpu_torch.train import adaptive as tta
from vqvae2_tpu_torch.train import vqvae_deep as ttd
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.jax_import import adaptive_deep_from_jax

HW = (64, 32)
P, K = 2, 2
CLASSES = 4
LR = 3e-4
NARROW = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-2
TENSOR_GRAD_RTOL = 1e-1
STEP_RTOL = 3e-1
STATS_RTOL = 1e-4

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


def test_threshold_up_mask_takes_jaxs_median():
    """162 values (the 18x9 map of 288x144) whose two middle values differ:
    the threshold is their mean, not ``torch.median``'s lower one; the
    resize is ``jax.image.resize``'s."""
    g = np.random.default_rng(0)
    act = g.uniform(0, 1, size=(3, 18, 9, 1)).astype(np.float32)
    flat = np.sort(act.reshape(3, -1), axis=1)
    lo, hi = flat[:, 80], flat[:, 81]
    assert np.all(hi - lo > 0)
    got_m = ttd.median(torch.from_numpy(act.reshape(3, -1)))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(jnp.median(act.reshape(3, -1), axis=1)))
    assert not torch.equal(got_m, torch.median(torch.from_numpy(act.reshape(3, -1)), dim=1).values)
    # a value between the lower middle value - 0.1 and the mean - 0.1 tells
    # the two apart; it replaces each map's smallest value, so the middle
    # values stay
    rows = act.reshape(3, -1)
    rows[np.arange(3), rows.argmin(1)] = lo + (hi - lo) / 4 - 0.1
    first = rows.argmin(1)
    am, up = ttd.threshold_up_mask(torch.from_numpy(act), (288, 144))
    wam, wup = jtd.threshold_up_mask(jnp.asarray(act), (288, 144))
    np.testing.assert_array_equal(am.numpy(), np.asarray(wam))
    np.testing.assert_allclose(up.numpy(), np.asarray(wup), rtol=1e-6, atol=1e-6)
    assert np.all(am.numpy().reshape(3, -1)[np.arange(3), first] == 0.0)


def test_random_gray_is_the_convex_mix():
    g = torch.Generator().manual_seed(3)
    img = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 8, 6, 3)).astype(np.float32))
    gray = ttd.random_gray(g, img)
    w = torch.rand((4, 3), generator=torch.Generator().manual_seed(3)) + 0.01
    w = w / w.sum(1, keepdim=True)
    want = np.einsum("bhwc,bc->bhw", img.numpy(), w.numpy())
    assert gray.shape == (4, 8, 6, 3)
    for c in range(3):
        np.testing.assert_allclose(gray[..., c].numpy(), want, rtol=1e-6, atol=1e-6)


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


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(ja, "VQVAE_Deep", functools.partial(ja.VQVAE_Deep, **NARROW))
    monkeypatch.setattr(ta, "VQVAE_Deep", functools.partial(ta.VQVAE_Deep, **NARROW))


@pytest.fixture
def pinned_gray(monkeypatch):
    """Both sides' gray mix from the same numpy weights (one set: the JAX
    step is traced once and keeps what its trace saw)."""
    w = np.random.default_rng(40).uniform(size=(P * K, 3)).astype(np.float32) + 0.01
    w = w / w.sum(1, keepdims=True)
    calls = {"jax": 0, "port": 0}

    def jax_mix(rng, img):
        calls["jax"] += 1
        return jnp.repeat(jnp.einsum("bhwc,bc->bhw", img, w)[..., None], 3, -1)

    def port_mix(generator, img):
        calls["port"] += 1
        return torch.einsum("bhwc,bc->bhw", img, torch.from_numpy(w))[..., None].repeat(1, 1, 1, 3)

    monkeypatch.setattr(jtd, "random_gray", jax_mix)
    monkeypatch.setattr(ttd, "random_gray", port_mix)
    return calls


def both_sides(variables):
    jm = ja.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    reid, gen = jtd._split_params(variables["params"])
    tx_reid, tx_gen = optax.adam(LR), optax.adam(LR)
    state = jtd.DeepState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"], vq_stats=variables["vq_stats"],
                          opt_reid=tx_reid.init(reid), opt_gen=tx_gen.init(gen))
    step = jtd.make_train_step(jm, tx_reid, tx_gen, K)
    model = ta.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    model.load_state_dict(adaptive_deep_from_jax(variables))
    ttx_reid, ttx_gen = schedules.adam(LR), schedules.adam(LR)
    tstate = tta.create_state(model, ttx_reid, ttx_gen)
    tstep = ttd.make_train_step(model, ttx_reid, ttx_gen, K)
    return state, step, model, tstate, tstep


def jax_vars(state):
    return host({"params": state.params, "batch_stats": state.batch_stats,
                 "vq_stats": state.vq_stats})


def jax_moments(state):
    """Adam's step count and first and second moments of every parameter,
    from the two optax states, as port ``state_dict`` names."""
    reid, gen = state.opt_reid[0], state.opt_gen[0]
    moments = [adaptive_deep_from_jax({"params": host({**m_gen, **m_reid})})
               for m_gen, m_reid in ((gen.mu, reid.mu), (gen.nu, reid.nu))]
    return int(reid.count), int(gen.count), moments[0], moments[1]


def sync(model, tstate, state):
    """Put the JAX state after a step (parameters, statistics, codebooks,
    Adam's moments) into the port's, so the next step starts from the same
    point on both sides."""
    model.load_state_dict(adaptive_deep_from_jax(jax_vars(state)))
    n_reid, n_gen, mu, nu = jax_moments(state)
    for name, p in model.named_parameters():
        reid = name.startswith("person_id.")
        opt = tstate.opt_reid if reid else tstate.opt_gen
        opt.state[p] = {"step": torch.tensor(float(n_reid if reid else n_gen)),
                        "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}


def adam_change(m, v, t, lr=LR, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam's update from its moments after ``t`` steps."""
    return -lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)


def assert_same_step(model, tstate, state, before, want, want_before):
    """For each optimizer: the two sides' gradients (Adam's first moment over
    ``1 - b1``, as one vector) within GRAD_RTOL of the JAX side's norm, each
    tensor's within TENSOR_GRAD_RTOL of its own norm or of the group's mean
    norm a tensor; the port's parameter change is optax's update from the
    port's moments; the two sides' changes within STEP_RTOL."""
    n_reid, n_gen, mu, nu = jax_moments(state)
    want, want_before = adaptive_deep_from_jax(want), adaptive_deep_from_jax(want_before)
    got = model.state_dict()
    groups = {}
    for name, p in model.named_parameters():
        reid = name.startswith("person_id.")
        opt, t = (tstate.opt_reid, n_reid) if reid else (tstate.opt_gen, n_gen)
        st = opt.state[p]
        m_got = st.get("exp_avg", torch.zeros_like(p)).double()
        d_got = (got[name] - before[name]).double()
        if "exp_avg" in st:
            rule = adam_change(m_got, st["exp_avg_sq"].double(), t)
            # the change is read off fp32 parameters: a rounding of up to
            # half an ulp of the parameter (6e-8 at 1.0) on a step of ~3e-4
            ulp = torch.finfo(torch.float32).eps * before[name].double().abs()
            assert bool(torch.all((d_got - rule).abs() <= 1e-4 * rule.abs() + ulp + 1e-12)), name
        groups.setdefault("reid" if reid else "gen", []).append(
            (name, m_got, mu[name].double(), d_got, (want[name] - want_before[name]).double()))
    for group, items in groups.items():
        norm2 = lambda k: sum(float(torch.sum(it[k] ** 2)) for it in items)   # noqa: E731
        g_err = sum(float(torch.sum((it[1] - it[2]) ** 2)) for it in items) ** 0.5
        g_norm = norm2(2) ** 0.5
        assert g_err <= GRAD_RTOL * g_norm, (group, "gradient", g_err / g_norm)
        mean_norm = g_norm / len(items) ** 0.5
        for name, a, b, _, _ in items:
            err, own = float(torch.linalg.norm(a - b)), float(torch.linalg.norm(b))
            assert err <= TENSOR_GRAD_RTOL * max(own, mean_norm), (name, err, own, mean_norm)
        s_err = sum(float(torch.sum((it[3] - it[4]) ** 2)) for it in items) ** 0.5
        assert s_err <= STEP_RTOL * norm2(4) ** 0.5, (group, "change", s_err / norm2(4) ** 0.5)


def assert_buffers(model, want):
    """Batch-norm and spectral-norm statistics and codebooks, each within
    STATS_RTOL of its largest element."""
    want = adaptive_deep_from_jax(want)
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        err = float(np.abs(buf.numpy() - w).max())
        assert err <= STATS_RTOL * max(float(np.abs(w).max()), 1e-6), (name, err)


def test_one_and_two_steps(sysu_dir, narrow, pinned_gray):
    """Two steps; the second from the JAX side's state after the first
    (parameters, statistics, codebooks, Adam's moments), so each is held from
    the same start."""
    jm = ja.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *HW, 3)), method=jm.init_probe))
    variables = seeded(shapes, 21)
    state, step, model, tstate, tstep = both_sides(variables)
    for i, batch in enumerate(batches(sysu_dir, 2)):
        if i:
            sync(model, tstate, state)
        want_before = jax_vars(state)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state, jm_metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch),
                                 jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(tm) == set(jm_metrics) == {"recon", "recon_feat", "latent", "id_ir",
                                              "feat_ir", "loss_reid", "loss_gen"}
        for k in jm_metrics:
            np.testing.assert_allclose(float(tm[k]), float(jm_metrics[k]), **METRIC_TOL,
                                       err_msg=k)
        assert_same_step(model, tstate, state, before, jax_vars(state), want_before)
        assert_buffers(model, jax_vars(state))
        assert tstate.step == int(state.step) == i + 1
    assert pinned_gray["jax"] >= 1 and pinned_gray["port"] == 2
    assert all(p.requires_grad for p in model.parameters())
    assert model.person_id.training


def test_the_frozen_pass_gives_the_reid_net_no_gradient(sysu_dir, narrow):
    """The ReID net runs in train mode for its own step and in eval mode for
    the generator's pass, and is back in train mode after; the generator's
    loss leaves its gradients as the ReID loss alone made them."""
    import copy

    from vqvae2_tpu_torch import losses as L

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ta.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    twin = copy.deepcopy(model)
    batch = {k: torch.from_numpy(v) for k, v in batches(sysu_dir, 1)[0].items()}
    tx = schedules.adam(LR)
    state = tta.create_state(model, tx, tx)
    seen = []
    handle = model.person_id.register_forward_hook(lambda m, a, out: seen.append(m.training))
    try:
        ttd.make_train_step(model, tx, tx, K)(state, batch)
    finally:
        handle.remove()
    assert seen == [True, False] and model.person_id.training

    feat, score, *_ = twin.encode_person(batch["rgb"], train=True)
    label = batch["label"].long()
    var = feat.reshape(P, K, -1).var(dim=1, correction=0).mean()
    (torch.nn.functional.cross_entropy(score, label) + L.triplet_loss(feat, label)[0]
     + var).backward()
    for (name, p), q in zip(model.person_id.named_parameters(), twin.person_id.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if q.grad is not None:
            assert torch.equal(p.grad, q.grad), name


def test_main_on_the_cpu(tmp_path, narrow):
    """Two steps through the command line on a 64x32 tree: a sample grid, a
    validation on a raw tree, the metrics and the checkpoints; then a third
    step by ``--resume``."""
    from PIL import Image

    raw = tmp_path / "SYSU-MM01"
    (raw / "exp").mkdir(parents=True)
    (raw / "exp" / "test_id.txt").write_text("1,2,3\n")
    g = np.random.default_rng(12)
    for cam in range(1, 7):
        for pid in (1, 2, 3):
            (raw / f"cam{cam}" / f"{pid:04d}").mkdir(parents=True)
            Image.fromarray(g.integers(0, 255, size=(64, 32, 3)).astype(np.uint8)).save(
                raw / f"cam{cam}" / f"{pid:04d}" / "0001.jpg")
    data = jreid.make_synthetic_sysu(str(tmp_path / "blobs"), n_ids=4, per_id=4, h=64, w=32)
    csv, ckpt, samples = (str(tmp_path / n) for n in ("m.csv", "ck", "s"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ta, "ModelAdaptive_Deep",
                   functools.partial(ta.ModelAdaptive_Deep, style_dim=16))
        mp.setattr(ttd, "ModelAdaptive_Deep",
                   functools.partial(ta.ModelAdaptive_Deep, style_dim=16))
        common = ["--path", data, "--device", "cpu", "--batch_size", "2", "--num_pos", "2",
                  "--log_every", "1", "--metrics_csv", csv, "--ckpt_dir", ckpt]
        m = ttd.main(common + ["--steps", "2", "--sample_dir", samples, "--sample_every", "2",
                               "--eval_every", "1", "--eval_path", str(raw)])
        assert np.isfinite(m["recon"]) and 0.0 <= m["mAP"] <= 1.0
        assert os.path.exists(os.path.join(samples, "00002.png"))
        saved = torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)
        assert saved["step"] == 2 and "adaptor.dec.conv1.weight" in saved["model"]
        assert not any(k.startswith(("conv1.", "conv2.")) for k in saved["model"])
        assert os.path.exists(os.path.join(ckpt, "best.pt"))
        os.replace(os.path.join(ckpt, "last.pt"), os.path.join(ckpt, "step_0000002.pt"))
        ttd.main(common + ["--steps", "1", "--resume"])
    assert torch.load(os.path.join(ckpt, "last.pt"), weights_only=True)["step"] == 3
    with open(csv) as f:
        assert len(f.read().strip().splitlines()) == 4


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    assert ttd.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttd.main(["--synthetic", "--steps", "1", "--ckpt_dir", str(tmp_path / "ck")])
    assert os.listdir(str(tmp_path)) == []
