"""The port's ``SSD300`` (``detection/ssd.py``) against the JAX package's:
``ExtraBlock`` alone at small sizes in train mode (flax's "SAME" pad at
stride 2 is (0, 1) at 10 -> 5, so a symmetric pad would move every output;
the ``pad_valid`` variant), with its new batch statistics and the
gradient; the whole model at 300 px, batch 1, eval mode (one JAX apply);
the head outputs' order, which ties each row to a default box; and
``import_torchvision_resnet`` filling the same stem, ``layer2`` and
``layer3`` tensors as the JAX import.

Weights: seeded numpy values for the JAX tree (kernels at variance 1 /
fan-in, batch norms off their initial values), carried across by
``ssd_from_jax``.  Tolerances: activations rtol 1e-4 / atol 1e-5 (fp32
convolutions summed in another order), the whole model's outputs (of size
up to 3, through 16 convolutions) rtol 1e-4 / atol 5e-5 (measured 1.4e-5);
each gradient
tensor within 1e-4 of its largest element; running statistics rtol 1e-5 /
atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.detection import ssd as js
from vqvae2_tpu.models import resnet as jr
from vqvae2_tpu_torch.detection import ssd as ts
from vqvae2_tpu_torch.models.layers import same_pads
from vqvae2_tpu_torch.models import resnet as tr
from vqvae2_tpu_torch.utils.jax_import import ssd_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=5e-5)
GRAD_RTOL = 1e-4


def seeded(shapes, seed):
    g = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", "")
        if leaf == "var":
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + g.normal(0, 0.1, s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def init(module, *args, seed=0):
    return seeded(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)), seed)


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("size,stride,pad_valid", [(10, 2, False), (9, 2, False), (19, 2, False),
                                                   (5, 1, True), (3, 1, True)])
def test_extra_block(size, stride, pad_valid):
    cin, mid, out = 8, 6, 10
    jmod = js.ExtraBlock(mid, out, stride=stride, pad_valid=pad_valid)
    x = np.random.default_rng(size).normal(size=(2, size, size + 1, cin)).astype(np.float32)
    variables = init(jmod, jnp.asarray(x), seed=size)
    tmod = ts.ExtraBlock(cin, mid, out, stride=stride, pad_valid=pad_valid)
    tmod.load_state_dict(ssd_from_jax(variables))

    def jloss(params):
        y, new = jmod.apply({**as_jax(variables), "params": params}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y)), (y, new)

    (_, (want, new)), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        as_jax(variables["params"]))
    got = tmod.train()(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    torch.sum(torch.sin(got)).backward()
    want_grads = ssd_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrad)})
    for name, p in tmod.named_parameters():
        scale = float(want_grads[name].abs().max())
        assert float((p.grad - want_grads[name]).abs().max()) <= GRAD_RTOL * scale, name
    want_stats = ssd_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, new["batch_stats"])})
    for name, buf in tmod.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), rtol=1e-5, err_msg=name)


def test_extra_block_pads_as_flax_same():
    assert same_pads(10, 3, 2) == (0, 1)
    assert same_pads(19, 3, 2) == (1, 1)
    assert same_pads(5, 3, 1) == (1, 1)


@pytest.fixture(scope="module")
def ssd_pair():
    jmod = js.SSD300(num_classes=6)
    x = np.random.default_rng(0).normal(size=(1, 300, 300, 3)).astype(np.float32)
    variables = init(jmod, jnp.asarray(x), seed=1)
    model = ts.SSD300(num_classes=6).eval()
    model.load_state_dict(ssd_from_jax(variables))
    return jmod, variables, model, x


def test_ssd300_eval_forward(ssd_pair):
    jmod, variables, model, x = ssd_pair
    loc_j, conf_j = jax.jit(lambda v, a: jmod.apply(v, a))(as_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        loc, conf = model(torch.from_numpy(x))
    assert tuple(loc.shape) == (1, 8732, 4) and tuple(conf.shape) == (1, 8732, 6)
    np.testing.assert_allclose(loc.numpy(), np.asarray(loc_j), **MODEL_TOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j), **MODEL_TOL)


def test_the_heads_rows_follow_the_jax_order(ssd_pair):
    """Row r of level 0 is (row, column, box) = divmod of r: the head's
    channel block of box k at pixel (i, j)."""
    _, _, model, x = ssd_pair
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x))
        loc0 = model.loc[0](feats[0])                          # (1, 38, 38, 16)
        loc, _ = model(torch.from_numpy(x))
    i, j, k = 7, 30, 3
    r = (i * 38 + j) * 4 + k
    torch.testing.assert_close(loc[0, r], loc0[0, i, j, 4 * k: 4 * k + 4], rtol=0, atol=0)
    assert [tuple(f.shape[1:3]) for f in feats] == [(38, 38), (19, 19), (10, 10), (5, 5),
                                                    (3, 3), (1, 1)]


def torchvision_state_dict(arch, seed):
    g = np.random.default_rng(seed)
    sd = {}
    for module in (tr.ResNetStem(arch), tr.ResNetTrunk(arch, last_stride_1=False)):
        for k, v in module.state_dict().items():
            sd[k] = torch.from_numpy(g.normal(scale=0.1, size=tuple(v.shape)).astype(np.float32))
            if k.endswith("running_var"):
                sd[k] = sd[k].abs() + 0.5
    return {"backbone.body." + k: v for k, v in sd.items()}


def test_import_torchvision_resnet_fills_layer2_and_layer3_as_the_jax_import_does():
    jmod = js.SSD300(num_classes=4)
    variables = init(jmod, jnp.zeros((1, 300, 300, 3)), seed=3)
    sd = torchvision_state_dict("resnet18", 4)
    jout, jn = jr.import_torchvision_resnet(variables, sd)
    model = ts.SSD300(num_classes=4)
    model.load_state_dict(ssd_from_jax(variables))
    n = tr.import_torchvision_resnet(model, sd)
    # the stem (conv1, bn1, layer1: 25 tensors), layer2 and layer3 (25 each)
    assert n == jn == 75
    want = ssd_from_jax(jax.tree_util.tree_map(np.asarray, jout))
    got = model.state_dict()
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    assert torch.equal(got["layer3.1.conv2.weight"], sd["backbone.body.layer3.1.conv2.weight"])
    assert torch.equal(got["layer2.0.downsample.1.running_var"],
                       sd["backbone.body.layer2.0.downsample.1.running_var"])
