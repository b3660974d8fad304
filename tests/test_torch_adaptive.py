"""The port's ``models/adaptive.py`` against the JAX package's: the variable
trees of ``ModelAdaptive`` (as the two trainers' init probes create it),
``ModelAdaptive_Deep`` (as ``init_probe`` creates it, at its full widths:
no ``conv1`` / ``conv2``, 34,734,942 parameters at four classes) and
``ModelAdaptiveBi_Deep`` name for name and shape for shape; and each method
the trainers call, on a narrowed ``VQVAE_Deep`` (channel 16, ``embed_dim`` 8)
at 64x32 with seeded weights: ``encode_person`` in train and eval mode (the
ReID net's mode given back as it was), ``encode_content`` /
``quantize_content``, ``fuse`` with and without ``train`` (the batch-norm and
spectral-norm statistics after it), ``decode`` with the style,
``encode_and_decode`` and ``discriminate``; for ``ModelAdaptive``
``encode_style``, ``encode_content`` (the EMA step), ``fuse`` and ``decode``.

Tolerance: rtol 1e-4 / atol 1e-5 for outputs of eval-mode batch norms and for
the adaptor; within 1e-4 of their largest element the outputs of the ReID net
in train mode (batch norms over a few rows, see ``test_torch_embed_net``) and
what follows a fusion in train mode: its batch norm normalises an attention
average that barely varies over the positions of a sample, and the classic
fusion's output lies 1.4e-5 (port) and 3.5e-5 (JAX package) of its largest
element off a float64 run of the port.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqvae2_tpu.models.adaptive as ja
from vqvae2_tpu.train import adaptive as jtrain_adaptive
from vqvae2_tpu.train import gray2color as jtrain_g2c
from vqvae2_tpu_torch.models import adaptive as ta
from vqvae2_tpu_torch.utils.jax_import import adaptive_deep_from_jax, adaptive_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_RTOL = 1e-4
HW = (64, 32)
CLASSES = 4
NARROW = dict(channel=16, n_res_block=1, n_res_channel=8, embed_dim=8, n_embed=16)

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


def images(seed, n=4):
    g = np.random.default_rng(seed)
    scale = np.linspace(0.5, 2.0, n).astype(np.float32)[:, None, None, None]
    return (g.normal(size=(n, *HW, 3)) * scale).astype(np.float32)


def seeded(shapes, seed):
    """LeCun-scaled kernels, scales 1 +- 0.1 (the non-local blocks' too, which
    flax starts at 0), biases and means +- 0.1, variances in [0.5, 1.5],
    ``u`` standard normal, ``sigma`` 1, codebooks standard normal."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf = keys[-1]
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


def deep_shapes(jm, hw=HW):
    return jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *hw, 3)), method=jm.init_probe))


def assert_same_tree(mapped, model):
    ours = model.state_dict()
    assert sorted(mapped) == sorted(ours)
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(ours[k].shape), k


def test_deep_variable_tree_name_for_name_at_full_width():
    jm = ja.ModelAdaptive_Deep(class_num=CLASSES)
    shapes = deep_shapes(jm, (288, 144))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert sorted(zeros["params"]) == ["adaptor", "discriminator", "fusion1", "fusion2",
                                       "person_id", "resblocks1_0", "resblocks1_1",
                                       "resblocks2_0", "resblocks2_1"]
    model = ta.ModelAdaptive_Deep(class_num=CLASSES)
    assert not hasattr(model, "conv1") and not hasattr(model, "conv2")
    assert_same_tree(adaptive_deep_from_jax(zeros), model)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 34734942


@pytest.mark.parametrize("probe", ["adaptive", "gray2color"])
def test_classic_variable_tree_name_for_name(probe):
    jm = ja.ModelAdaptive(class_num=CLASSES)
    fn = {"adaptive": jtrain_adaptive._init_probe, "gray2color": jtrain_g2c._init_probe}[probe]
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *HW, 3)), method=fn))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = ta.ModelAdaptive(class_num=CLASSES, ir_head=probe == "adaptive")
    assert_same_tree(adaptive_from_jax(zeros), model)


def test_bi_variable_tree_name_for_name():
    """Every method of the JAX module (its fusions none calls, so the port
    has none)."""
    jm = ja.ModelAdaptiveBi_Deep(class_num=CLASSES, style_dim=16)

    def probe(m, img):
        feat, _, x4, _, x3 = m.encode_person(img)
        outs = []
        for i in (1, 2):
            b, t = getattr(m, f"encode_content_{i}")(img)
            content, _ = getattr(m, f"quantize_content_{i}")(b, t)
            outs.append(getattr(m, f"decode_{i}")(content, feat))
        return outs, m.discriminate(feat)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ja, "VQVAE_Deep", functools.partial(ja.VQVAE_Deep, **NARROW))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((2, *HW, 3)),
                                                method=probe))
        mp.setattr(ta, "VQVAE_Deep", functools.partial(ta.VQVAE_Deep, **NARROW))
        model = ta.ModelAdaptiveBi_Deep(class_num=CLASSES, style_dim=16)
    assert sorted(shapes["params"]) == ["adaptor1", "adaptor2", "discriminator", "person_id"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert_same_tree(adaptive_from_jax(zeros), model)


@pytest.fixture(scope="module")
def narrow_deep():
    """The JAX and port ``ModelAdaptive_Deep`` on the narrowed VQVAE_Deep,
    seeded weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(ja, "VQVAE_Deep", functools.partial(ja.VQVAE_Deep, **NARROW))
    mp.setattr(ta, "VQVAE_Deep", functools.partial(ta.VQVAE_Deep, **NARROW))
    jm = ja.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    variables = seeded(deep_shapes(jm), 3)
    model = ta.ModelAdaptive_Deep(class_num=CLASSES, style_dim=16)
    model.load_state_dict(adaptive_deep_from_jax(variables))
    yield jm, variables, model
    mp.undo()


def fresh(model, variables):
    model.load_state_dict(adaptive_from_jax(variables))
    return model


def within(got, want, rtol=TRAIN_RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rtol * float(np.abs(want).max())


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("train", [False, True])
def test_encode_person_gives_the_mode_back(narrow_deep, train):
    jm, variables, model = narrow_deep
    fresh(model, variables).person_id.eval()
    x = images(1)
    got = model.encode_person(torch.from_numpy(x), train=train)
    assert not model.person_id.training and not model.person_id.base_resnet.layer4[0].bn1.training
    want, upd = jm.apply(variables, jnp.asarray(x), train=train, method=jm.encode_person,
                         mutable=["batch_stats"])
    for g, w in zip(got, want):
        within(g, w) if train else close(g, w)
    stats = adaptive_from_jax({**variables, "batch_stats": host(upd["batch_stats"])})
    for name, buf in model.person_id.named_buffers():
        within(buf, stats[f"person_id.{name}"].numpy())


@pytest.mark.parametrize("train", [False, True])
def test_content_fusion_and_decode(narrow_deep, train):
    """encode_content -> fuse (x3 / x4 as the person features) ->
    quantize_content -> decode with the person feature as the style, and
    discriminate; with ``train`` the fusions' batch norms and the spectral
    norms move, and the codebooks take their EMA step."""
    jm, variables, model = narrow_deep
    fresh(model, variables)
    x = images(2)
    g = np.random.default_rng(4)
    x3 = g.normal(size=(4, 4, 2, 256)).astype(np.float32)
    x4 = g.normal(size=(4, 4, 2, 512)).astype(np.float32)
    feat = g.normal(size=(4, 512)).astype(np.float32)

    def jax_path(m, img, x3, x4, feat):
        b, t = m.encode_content(img)
        cb, ct = m.fuse(b, t, x3, x4, train=train)
        content, diff = m.quantize_content(cb, ct, train=train)
        return cb, ct, content, diff, m.decode(content, feat), m.discriminate(feat)

    want, upd = jm.apply(variables, *(jnp.asarray(a) for a in (x, x3, x4, feat)),
                         method=jax_path, mutable=["batch_stats", "vq_stats"])
    t = [torch.from_numpy(a) for a in (x, x3, x4, feat)]
    b, tt = model.encode_content(t[0])
    cb, ct = model.fuse(b, tt, t[1], t[2], train=train)
    content, diff = model.quantize_content(cb, ct, train=train)
    got = (cb, ct, content, diff, model.decode(content, t[3]), model.discriminate(t[3]))
    for i, (gg, w) in enumerate(zip(got, want)):
        within(gg, w) if train and i != 3 else close(gg, w)
    after = adaptive_from_jax({"params": variables["params"],
                               "batch_stats": host(upd["batch_stats"]),
                               "vq_stats": host(upd["vq_stats"])})
    for name, buf in model.named_buffers():
        if not name.startswith("person_id."):
            close(buf, after[name].numpy(), rtol=1e-4, atol=1e-6)
    (within if train else close)(model.encode_and_decode(t[0], t[3]),
          jm.apply(after_vars(variables, upd), jnp.asarray(x), jnp.asarray(feat),
                   method=jm.encode_and_decode))


def after_vars(variables, upd):
    return {"params": variables["params"], **host(upd)}


@pytest.mark.parametrize("train", [False, True])
def test_classic_model_methods(train):
    jm = ja.ModelAdaptive(class_num=CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, *HW, 3)), method=jtrain_adaptive._init_probe))
    variables = seeded(shapes, 5)
    model = fresh(ta.ModelAdaptive(class_num=CLASSES), variables)
    x, y = images(6), images(7)

    def jax_path(m, img, other):
        s = m.encode_style(other)
        content, diff = m.encode_content(img, train=train)
        fused = m.fuse(content, s, train=train)
        return s, content, diff, fused, m.decode(fused)

    want, upd = jm.apply(variables, jnp.asarray(x), jnp.asarray(y), method=jax_path,
                         mutable=["batch_stats", "vq_stats"])
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    s = model.encode_style(yt)
    content, diff = model.encode_content(xt, train=train)
    fused = model.fuse(content, s, train=train)
    for i, (g, w) in enumerate(zip((s, content, diff, fused, model.decode(fused)), want)):
        within(g, w) if train and i >= 3 else close(g, w)
    after = adaptive_from_jax(after_vars(variables, upd))
    for name, buf in model.named_buffers():
        if not name.startswith("person_id."):
            close(buf, after[name].numpy(), rtol=1e-4, atol=1e-6)


def test_mode_and_frozen_helpers():
    net = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.BatchNorm1d(3))
    net[1].eval()
    with ta.mode(net, True):
        assert net.training and net[1].training
    assert net.training and not net[1].training
    x = torch.ones(2, 3, requires_grad=True)
    with ta.frozen(net):
        y = net[0](x).sum()
    y.backward()
    assert net[0].weight.grad is None and x.grad is not None
    assert all(p.requires_grad for p in net.parameters())
