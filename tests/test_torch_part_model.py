"""The port's parsing head and ``EmbedNet2`` against the JAX package's:
``_resize`` and the PSP bins (``jax.image.resize`` anti-aliases when it shrinks;
at an 18x9 grid the 2x2 and 6x6 bins do not divide it), ``NonLocalSelf`` (one
inter channel, ``f / N``, no softmax), ``PSPModule``, ``EdgeModule``,
``DecoderModule``, ``PartModel`` in train and eval mode with their ABN
statistics, and ``EmbedNet2`` (resnet18, 96x48) in eval mode — the pair
``(l2(x_pool), l2(feats))`` — and in train mode — the 10-tuple — with the
running statistics after it.

The parsing head's dropout is fixed in the model on both sides; these tests
replace it with the identity on both sides (flax's ``nn.Dropout`` and the
port's ``part_model.dropout``).  Weights: seeded numpy values carried across
by ``embed_net2_from_jax``.  Tolerance rtol 1e-4 / atol 1e-5 (fp32
convolutions summed in another order through a network) in eval mode.  In
train mode each output tensor is held within 1e-4 of its largest element: a
batch norm over a few rows (the PSP 1x1 stage sees one row an image) divides
by a variance taken as ``E[x^2] - E[x]^2``, which amplifies the rounding of
the sums, and the JAX package's own CPU forward is off a float64 one by up to
3e-5 there while the port's is within 1e-6
(``test_nonlocal_self_is_unnormalised_with_one_inter_channel``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqvae2_tpu.part import part_model as jp
from vqvae2_tpu_torch.part import part_model as tp
from vqvae2_tpu_torch.utils.jax_import import embed_net2_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_RTOL = 1e-4
HW = (96, 48)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded(shapes, seed, nonlocal_scale=0.0):
    """Seeded values for a variable tree of ``shapes``: He-scaled kernels,
    batch-norm and ABN scales 1 +- 0.1 (ABN weights of either sign where
    ``seed`` is odd), biases and means +- 0.1, variances in [0.5, 1.5]; the
    non-local blocks' output scales ``nonlocal_scale`` +- 0.1 times it (flax
    starts them at 0: larger ones make a deep eval forward blow up on seeded
    statistics)."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf, owner = keys[-1], "/".join(keys[:-1])
        if leaf in ("var", "running_var"):
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "running_mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf in ("scale", "weight"):
            if "W_bn" in owner:
                return (nonlocal_scale * (1 + g.normal(0, 0.1, s.shape))).astype(np.float32)
            sign = np.where(g.random(s.shape) < 0.3, -1.0, 1.0) if seed % 2 else 1.0
            return (sign * (1 + g.normal(0, 0.1, s.shape))).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        gain = 2.0 if len(s.shape) == 4 else 1.0
        return (g.normal(size=s.shape) * np.sqrt(gain / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def variables_for(module, *args, seed=0, nonlocal_scale=0.0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return seeded(shapes, seed, nonlocal_scale)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(tp, "dropout", lambda x, *a, **k: x)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(a, b, what=""):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b), **TOL, err_msg=what)


def _close_scaled(a, b, what=""):
    """Within TRAIN_RTOL of the largest element of ``b``."""
    a, b = np.asarray(a.detach()), np.asarray(b)
    err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= TRAIN_RTOL * scale + TOL["atol"], (what, err, scale)


@pytest.mark.parametrize("src,dst", [((18, 9), (2, 2)), ((18, 9), (6, 6)), ((18, 9), (72, 36)),
                                     ((18, 9), (3, 3)), ((6, 3), (6, 3)), ((1, 1), (18, 9))])
def test_resize_is_jax_image_resize(src, dst):
    x = _x(2, *src, 5)
    want = jax.image.resize(jnp.asarray(x), (2, *dst, 5), "bilinear")
    _close(tp._resize(torch.from_numpy(x), dst), want)
    if dst[0] <= src[0] and dst[1] <= src[1]:
        _close(tp._adaptive_avg_pool(torch.from_numpy(x), dst),
               jp._adaptive_avg_pool(jnp.asarray(x), dst))


def test_non_divisible_bins_are_not_adaptive_avg_pool():
    """The shrinking bins are the anti-aliased linear resize: torch's uneven
    adaptive bins and the resize without anti-aliasing are both far off."""
    x = _x(1, 18, 9, 4, seed=1)
    want = np.asarray(jp._adaptive_avg_pool(jnp.asarray(x), (2, 2)))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    adaptive = F.adaptive_avg_pool2d(nchw, (2, 2)).permute(0, 2, 3, 1).numpy()
    plain = F.interpolate(nchw, size=(2, 2), mode="bilinear", align_corners=False,
                          antialias=False).permute(0, 2, 3, 1).numpy()
    _close(tp._adaptive_avg_pool(torch.from_numpy(x), (2, 2)), want)
    assert np.abs(adaptive - want).max() > 1e-3 and np.abs(plain - want).max() > 1e-2


def _train_then_eval(jmod, tmod, variables, args, kw=None):
    """Train mode (outputs and the moved statistics), then eval mode on them;
    ``args`` numpy inputs; returns the torch train-mode outputs."""
    kw = kw or {}
    tmod.load_state_dict(embed_net2_from_jax(variables))
    jargs = [jnp.asarray(a) for a in args]
    jout, new = jax.jit(lambda v, *a: jmod.apply(v, *a, train=True, mutable=["batch_stats"],
                                                 **kw))(variables, *jargs)
    tout = tmod.train()(*[torch.from_numpy(a) for a in args])
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tout),
                            jax.tree_util.tree_leaves(jout)):
        _close_scaled(a, b, jax.tree_util.keystr(path))
    moved = embed_net2_from_jax({"batch_stats": host(new["batch_stats"])})
    for name, buf in tmod.named_buffers():
        _close_scaled(buf, moved[name].numpy(), name)
    variables = {**variables, "batch_stats": host(new["batch_stats"])}
    jeval = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(variables, *jargs)
    with torch.no_grad():
        teval = tmod.eval()(*[torch.from_numpy(a) for a in args])
    for a, b in zip(jax.tree_util.tree_leaves(teval), jax.tree_util.tree_leaves(jeval)):
        _close(a, b)
    return tout


@pytest.mark.parametrize("grid", [(18, 9), (6, 3)])
def test_psp_module(grid):
    x = _x(2, *grid, 8, seed=2)
    jmod = jp.PSPModule(out_features=16)
    variables = variables_for(jmod, jnp.asarray(x), seed=3)
    _train_then_eval(jmod, tp.PSPModule(8, 16), variables, [x])


def test_aspp_module(no_dropout):
    x = _x(2, 6, 3, 8, seed=30)
    jmod = jp.ASPPModule(inner_features=8, out_features=16, dilations=(1, 2))
    variables = variables_for(jmod, jnp.asarray(x), seed=31)
    _train_then_eval(jmod, tp.ASPPModule(8, 8, 16, dilations=(1, 2)), variables, [x])


def test_nonlocal_self_is_unnormalised_with_one_inter_channel():
    x = _x(2, 6, 3, 8, seed=4)
    jmod = jp.NonLocalSelf()
    variables = variables_for(jmod, jnp.asarray(x), seed=5, nonlocal_scale=1.0)
    tmod = tp.NonLocalSelf(8)
    got = _train_then_eval(jmod, tmod, variables, [x]).detach().numpy()
    assert tmod.g.weight.shape == (1, 8, 1, 1)
    # the gap is the JAX side's rounding: against a float64 forward of the same
    # module the port is closer by more than an order of magnitude
    tmod.load_state_dict(embed_net2_from_jax(variables))
    f64 = tmod.double().train()(torch.from_numpy(x).double()).detach().numpy()
    jout, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert np.abs(got - f64).max() * 10 < np.abs(np.asarray(jout) - f64).max()
    tmod.float()
    tmod.W_bn.weight.data.zero_()
    tmod.W_bn.bias.data.zero_()
    assert torch.equal(tmod.eval()(torch.from_numpy(x)), torch.from_numpy(x))


def test_edge_module_shares_its_logit_convolution():
    x1, x2, x3 = _x(2, 24, 12, 8, seed=6), _x(2, 12, 6, 12, seed=7), _x(2, 6, 3, 16, seed=8)
    jmod = jp.EdgeModule(mid_fea=16)
    variables = variables_for(jmod, *(jnp.asarray(a) for a in (x1, x2, x3)), seed=9)
    tmod = tp.EdgeModule((8, 12, 16), mid_fea=16)
    _train_then_eval(jmod, tmod, variables, [x1, x2, x3])
    assert sorted(k for k in tmod.state_dict() if k.startswith("conv4")) == [
        "conv4.bias", "conv4.weight"]


def test_decoder_module():
    xt, xl = _x(2, 6, 3, 16, seed=10), _x(2, 24, 12, 8, seed=11)
    jmod = jp.DecoderModule(num_classes=7)
    variables = variables_for(jmod, jnp.asarray(xt), jnp.asarray(xl), seed=13)
    seg, fea = _train_then_eval(jmod, tp.DecoderModule(7, (16, 8)), variables, [xt, xl])
    assert seg.shape == (2, 24, 12, 7) and fea.shape == (2, 24, 12, 256)


def test_part_model(no_dropout):
    x4, x1 = _x(2, 6, 3, 16, seed=12), _x(2, 24, 12, 8, seed=13)
    x2, x3 = _x(2, 12, 6, 8, seed=14), _x(2, 6, 3, 12, seed=15)
    jmod = jp.PartModel(num_part=7)
    variables = variables_for(jmod, *(jnp.asarray(a) for a in (x4, x1, x2, x3)), seed=16)
    tmod = tp.PartModel(7, (16, 8, 8, 12))
    _train_then_eval(jmod, tmod, variables, [x4, x1, x2, x3])


def test_part_model_needs_a_generator_to_train():
    tmod = tp.PartModel(7, (16, 8, 8, 12)).train()
    args = [torch.from_numpy(a) for a in (_x(2, 6, 3, 16), _x(2, 24, 12, 8), _x(2, 12, 6, 8),
                                          _x(2, 6, 3, 12))]
    with pytest.raises(ValueError, match="generator"):
        tmod(*args)
    a = tmod(*args, generator=torch.Generator().manual_seed(0))[0][0][1]
    b = tmod(*args, generator=torch.Generator().manual_seed(0))[0][0][1]
    c = tmod(*args, generator=torch.Generator().manual_seed(1))[0][0][1]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def embed_net2():
    """resnet18 EmbedNet2 on both sides with one set of seeded variables."""
    jmod = jp.EmbedNet2(class_num=4, arch="resnet18")
    probe = jnp.zeros((1, *HW, 3))
    variables = variables_for(jmod, seed=17, xRGB=probe, xIR=probe, xZ=probe, modal=0,
                              train=True)
    tmod = tp.EmbedNet2(class_num=4, arch="resnet18")
    tmod.load_state_dict(embed_net2_from_jax(variables))
    return jmod, tmod, variables


def test_embed_net2_eval_returns_the_normalised_pair(embed_net2):
    jmod, tmod, variables = embed_net2
    x = _x(2, *HW, 3, seed=18)
    for modal, key in ((1, "xRGB"), (2, "xIR")):
        want = jax.jit(lambda v, a: jmod.apply(v, modal=modal, **{key: a}))(variables,
                                                                             jnp.asarray(x))
        with torch.no_grad():
            got = tmod.eval()(modal=modal, **{key: torch.from_numpy(x)})
        assert len(got) == 2 and got[1].shape == (2, 512 + 6 * 256)
        for a, b in zip(got, want):
            _close(a, b)
        np.testing.assert_allclose(torch.linalg.norm(got[1], dim=1).numpy(), 1.0, rtol=1e-5)


def test_embed_net2_train_returns_the_ten_tuple(embed_net2, no_dropout):
    jmod, tmod, variables = embed_net2
    rgb, ir, gray = (_x(2, *HW, 3, seed=s) for s in (19, 20, 21))
    jout, new = jax.jit(lambda v, a, b, c: jmod.apply(
        v, xRGB=a, xIR=b, xZ=c, modal=0, train=True, mutable=["batch_stats"]))(
        variables, *(jnp.asarray(a) for a in (rgb, ir, gray)))
    tmod.load_state_dict(embed_net2_from_jax(variables))
    tout = tmod.train()(xRGB=torch.from_numpy(rgb), xIR=torch.from_numpy(ir),
                        xZ=torch.from_numpy(gray), modal=0)
    assert len(tout) == 10 and tout[3] is None
    names = ("feats", "score", "part_preds", None, "masked_feat_x3", "masked_feat",
             "part_masks", "parts_score", "feats_p", "score_p")
    for name, a, b in zip(names, tout, jout):
        if name is None:
            continue
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            _close_scaled(x, y, name)
    assert tout[0].shape == (6, 512 + 6 * 256) and tout[6].shape == (6, 6, 3, 7)
    moved = embed_net2_from_jax({"batch_stats": host(new["batch_stats"])})
    for name, buf in tmod.named_buffers():
        _close_scaled(buf, moved[name].numpy(), name)
    # with_feature in eval mode gives the tuple too
    with torch.no_grad():
        assert len(tmod.eval()(xRGB=torch.from_numpy(rgb), modal=1, with_feature=True)) == 10
