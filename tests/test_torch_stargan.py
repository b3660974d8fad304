"""The port's ``models/stargan.py`` against the JAX package's, from the same
seeded variables (``stargan_from_jax``) on the same inputs: ``ResBlk`` (with
and without instance norms, downsampling and a width change),
``AdainResBlkV2`` (with and without the high-pass, upsampling; the shortcut's
parameters exist with ``w_hpf > 0`` too), ``high_pass``, the ``Generator``
(16x16 inputs at ``img_size`` 64, and 64x64 with the two masks, which take
the skip cache at heights 64 and 32), its refusal of indivisible geometry,
``MappingNetwork``, ``StyleEncoder`` and ``DiscriminatorV2`` at 64x64;
``ModelStarGAN``'s variables name for name against what the StarGAN
trainer's init probe creates at 288x144 (``img_size`` 128); the R1 penalty
and its gradient in D's parameters against ``jax.grad`` of the JAX trainer's
``disc_loss_fn``; and ``remat`` on and off bit for bit.

Tolerances: rtol 1e-5 / atol 1e-6 for the blocks, the mapping network, the
style encoder and the discriminator; the generator's output within 1e-4 of
its largest element (its instance norms normalise over 2x2 maps at the
bottleneck of a 16x16 input, which magnifies the fp32 rounding; measured
6e-5); the R1 value rtol 1e-4; D's gradient, through R1's gradient of a
gradient, within 1e-3 of its norm as one vector and each tensor within 1e-2
of its own norm (measured 1.7e-4, and 1.0e-3 for ``conv_in``, whose
second-order terms meet the inputs directly).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqvae2_tpu.models.stargan as js
from vqvae2_tpu.train import stargan_bi as jsb
from vqvae2_tpu_torch.models import stargan as ts
from vqvae2_tpu_torch.utils.jax_import import stargan_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def seeded(shapes, seed):
    """LeCun-scaled kernels; biases, instance-norm shifts and batch-norm means
    N(0, 0.1); scales 1 + N(0, 0.1); variances in [0.5, 1.5]."""
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


def both(jm, tm, args, seed=0):
    """``jm``'s variables seeded, carried into ``tm``; the two outputs."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = seeded(shapes, seed)
    sd = stargan_from_jax(variables)
    assert sorted(sd) == sorted(tm.state_dict())
    tm.load_state_dict(sd)
    want = np.asarray(jm.apply(variables, *args))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(np.asarray(a)) for a in args))
    return got, want


def nchw(f):
    """A port block (NCHW) applied to ``(B, H, W, C)``."""
    class Wrapped(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def state_dict(self, *a, **k):
            return self.m.state_dict(*a, **k)

        def load_state_dict(self, sd, *a, **k):
            return self.m.load_state_dict(sd, *a, **k)

        def forward(self, x, *rest):
            return self.m(x.permute(0, 3, 1, 2), *rest).permute(0, 2, 3, 1)
    return Wrapped(f)


def inputs(seed, *shapes):
    g = np.random.default_rng(seed)
    return [g.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("normalize,downsample,dims", [
    (True, True, (8, 16)), (False, True, (8, 8)), (True, False, (16, 16)), (False, False, (8, 12))])
def test_resblk(normalize, downsample, dims):
    x, = inputs(1, (2, 8, 8, dims[0]))
    got, want = both(js.ResBlk(dims[1], normalize=normalize, downsample=downsample),
                     nchw(ts.ResBlk(*dims, normalize=normalize, downsample=downsample)), (x,))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("w_hpf,upsample,dims", [
    (0, True, (16, 8)), (0, False, (8, 8)), (1, True, (16, 8)), (1, False, (8, 8))])
def test_adain_resblk_v2(w_hpf, upsample, dims):
    x, s = inputs(2, (2, 4, 4, dims[0]), (2, 10))
    tm = ts.AdainResBlkV2(*dims, style_dim=10, w_hpf=w_hpf, upsample=upsample)
    assert hasattr(tm, "conv1x1") == (dims[0] != dims[1])
    got, want = both(js.AdainResBlkV2(dims[1], w_hpf=w_hpf, upsample=upsample), nchw(tm), (x, s))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_high_pass():
    x, = inputs(3, (2, 6, 5, 4))
    got = ts.high_pass(torch.from_numpy(x).permute(0, 3, 1, 2), 2.0).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(js.high_pass(jnp.asarray(x), 2.0)), **TOL)


def test_generator_at_16px():
    x, s = inputs(4, (2, 16, 16, 3), (2, 64))
    got, want = both(js.Generator(img_size=64, style_dim=64), ts.Generator(64, 64), (x, s))
    assert got.shape == want.shape == (2, 16, 16, 1)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())


def test_generator_with_masks():
    """64x64 at ``img_size`` 64: the cache at heights 64 and 32, the masks
    resized bilinearly with antialiasing (16x16 -> 32, 32x32 -> 64)."""
    x, s = inputs(5, (1, 64, 64, 3), (1, 32))
    g = np.random.default_rng(6)
    masks = (g.uniform(size=(1, 16, 16, 1)).astype(np.float32),
             g.uniform(size=(1, 32, 32, 1)).astype(np.float32))
    jm, tm = js.Generator(img_size=64, style_dim=32), ts.Generator(64, 32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, s, masks))
    variables = seeded(shapes, 7)
    tm.load_state_dict(stargan_from_jax(variables))
    want = np.asarray(jm.apply(variables, x, s, masks))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(s), tuple(map(torch.from_numpy, masks)))
        plain = tm(torch.from_numpy(x), torch.from_numpy(s))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())
    assert not np.allclose(got.numpy(), plain.numpy())


def test_generator_refuses_indivisible_geometry():
    tm = ts.Generator(img_size=256, style_dim=8)
    with pytest.raises(ValueError, match="divisible by 32"):
        tm(torch.zeros(1, 288, 144, 3), torch.zeros(1, 8))
    with pytest.raises(ValueError, match="divisible by 32"):
        js.Generator(img_size=256, style_dim=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 288, 144, 3)), jnp.zeros((1, 8)))


def test_mapping_network():
    z, = inputs(8, (4, 24))
    y = np.array([0, 1, 1, 0], np.int32)
    got, want = both(js.MappingNetwork(16, 2), ts.MappingNetwork(24, 16, 2), (z, y))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["StyleEncoder", "DiscriminatorV2"])
def test_style_encoder_and_discriminator_at_64px(name):
    x, = inputs(9, (2, 64, 64, 3))
    y = np.array([1, 0], np.int32)
    kw = {"StyleEncoder": dict(style_dim=16), "DiscriminatorV2": {}}[name]
    got, want = both(getattr(js, name)(img_size=64, **kw), getattr(ts, name)(64, **kw), (x, y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_generator_img_size():
    from vqvae2_tpu_torch.train.stargan_bi import _generator_img_size

    for hw in ((288, 144), (64, 64), (96, 48), (256, 128), (100, 60)):
        assert _generator_img_size(*hw) == jsb._generator_img_size(*hw)
    assert _generator_img_size(288, 144) == 128


def test_model_variables_are_the_trainer_init_probes():
    """What the trainer's ``init_probe`` creates at 288x144 (``img_size`` 128,
    eight probe images), traced without running it; the port's model holds
    the same names and shapes."""
    h, w, classes = 288, 144, 4
    jm = js.ModelStarGAN(class_num=classes, img_size=jsb._generator_img_size(h, w))
    probe = jnp.zeros((8, h, w, 3), jnp.float32)

    def init_probe(module):
        feat, *_ = module.person_id(xRGB=probe, xIR=probe, modal=0, with_feature=True)
        fv, fi = jnp.split(feat, 2, axis=0)
        module.gen_1(probe, fi)
        module.gen_2(probe, fv)
        return module.discriminate(probe, jnp.zeros((8,), jnp.int32))

    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "dropout": jax.random.PRNGKey(1)},
                                            method=init_probe))
    assert sorted(shapes["params"]) == ["adaptor1", "adaptor2", "discriminator", "mapping",
                                        "person_id"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    mapped = stargan_from_jax(zeros)
    ours = ts.ModelStarGAN(class_num=classes, img_size=128).state_dict()
    assert sorted(mapped) == sorted(ours)
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(ours[k].shape), k
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(v.numel() for k, v in ours.items() if not k.endswith(("running_mean",
                                                                     "running_var"))) == n_jax


@pytest.fixture(scope="module")
def d64():
    """The JAX ModelStarGAN's discriminator at ``img_size`` 64, seeded, and
    the port's from the same variables; a gray / IR pair and translations."""
    jm = js.ModelStarGAN(class_num=4, img_size=64)
    x = jnp.zeros((2, 64, 64, 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, jnp.zeros((2,), jnp.int32),
                                            method=jm.discriminate))
    variables = seeded(shapes, 11)
    tm = ts.ModelStarGAN(class_num=4, img_size=64)
    sd = stargan_from_jax(variables)
    assert set(sd) == {k for k in tm.state_dict() if k.startswith("discriminator.")}
    tm.load_state_dict(sd, strict=False)
    gray, ir, g2i, i2g = inputs(12, *[(1, 64, 64, 3)] * 4)
    return jm, variables, tm, (gray, ir, g2i, i2g)


def port_disc_grads(tm, data, create_graph=True):
    from vqvae2_tpu_torch.train import stargan_bi as tsb

    _, _, disc_loss = tsb.make_loss_fns(tm, 1)
    tm.zero_grad(set_to_none=True)
    loss, (real, fake, r1) = disc_loss(*(torch.from_numpy(a) for a in data), 1.0, create_graph)
    loss.backward()
    return loss, r1, {n: p.grad.clone() for n, p in tm.discriminator.named_parameters()}


def test_r1_and_its_gradient_against_jax_grad(d64):
    jm, variables, tm, data = d64
    _, _, disc_loss_fn = jsb.make_loss_fns(jm, 1)
    (loss, (real, fake, r1)), grads = jax.value_and_grad(disc_loss_fn, has_aux=True)(
        {"discriminator": variables["params"]["discriminator"]}, {}, {}, *data, 1.0)
    want = stargan_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads)})
    got_loss, got_r1, got = port_disc_grads(tm, data)
    assert float(r1) > 0
    np.testing.assert_allclose(float(got_r1.detach()), float(r1), rtol=1e-4)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-4)
    err = sum(float(((got[k[len("discriminator."):]] - want[k]) ** 2).sum()) for k in want)
    norm = sum(float((want[k] ** 2).sum()) for k in want)
    assert err ** 0.5 <= 1e-3 * norm ** 0.5
    for k in want:
        g, w = got[k[len("discriminator."):]], want[k]
        assert float((g - w).norm()) <= 1e-2 * float(w.norm()) + 1e-12, k
    # without R1's own gradient the parameters' gradient differs
    _, _, no_r1 = port_disc_grads(tm, data, create_graph=False)
    assert any(not torch.equal(no_r1[k], got[k]) for k in got)


def test_remat_gives_bit_equal_gradients(d64):
    _, _, tm, data = d64
    twin = ts.ModelStarGAN(class_num=4, img_size=64, remat=False)
    twin.load_state_dict(tm.state_dict())
    loss_a, r1_a, a = port_disc_grads(tm, data)
    loss_b, r1_b, b = port_disc_grads(twin, data)
    assert tm.remat and not twin.remat
    assert torch.equal(loss_a, loss_b) and torch.equal(r1_a, r1_b)
    assert all(torch.equal(a[k], b[k]) for k in a)
