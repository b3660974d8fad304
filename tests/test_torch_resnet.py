"""The port's ResNet backbone against the JAX package's: the two block types
with stride and downsample, the stem and the trunk of resnet18 in train and
eval mode, the gradients of a train-mode forward, the flax BatchNorm's buffers
after it (biased batch variance, momentum 0.99 — not torch's unbiased update),
and ``import_torchvision_resnet`` from a seeded torchvision-layout
``state_dict`` into every stem and the trunk of ``EmbedNet2``, against the JAX
import.

Weights: the flax initialisers, with the batch norms' scales, biases and
running statistics moved off their initial values by seeded numpy noise, carried
across by ``embed_net2_from_jax``.  Tolerance rtol 1e-4 / atol 1e-5 on
activations (fp32 convolutions summed in another order through a few layers);
each gradient tensor within 1e-4 of its largest element (a batch norm's
backward subtracts means, so small elements carry the rounding of large ones);
the running statistics rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models import resnet as jr
from vqvae2_tpu.part.part_model import EmbedNet2 as JEmbedNet2
from vqvae2_tpu_torch.models import resnet as tr
from vqvae2_tpu_torch.part.part_model import EmbedNet2
from vqvae2_tpu_torch.utils.jax_import import embed_net2_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-4


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded(variables, seed):
    """flax's initial variables with every batch norm moved off its initial
    values (scale 1 +- 0.1, bias and mean +- 0.1, var in [0.5, 1.5])."""
    g = np.random.default_rng(seed)

    def move(path, a):
        leaf = getattr(path[-1], "key", "")
        if leaf == "var":
            return g.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf in ("scale", "bias", "mean"):
            return (a + g.normal(scale=0.1, size=a.shape)).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(move, host(variables))


def init(module, *args, seed=0):
    return seeded(jax.jit(lambda *a: module.init(jax.random.PRNGKey(seed), *a))(*args), seed)


def loss(y):
    """Summed sine, of a jnp or a torch tensor."""
    return jnp.sum(jnp.sin(y)) if isinstance(y, jax.Array) else torch.sum(torch.sin(y))


def run_both(jmod, tmod, variables, x):
    """Train-mode forward (with the new batch statistics) and parameter
    gradients of ``loss``, then eval mode on the moved statistics, on both
    sides; asserts the agreement."""
    tmod.load_state_dict(embed_net2_from_jax(variables))

    def jloss(params):
        out, new = jmod.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        flat = out if isinstance(out, tuple) else (out,)
        return sum(loss(o) for o in flat), (flat, new)

    (_, (jout, new)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tout = tmod.train()(torch.from_numpy(x))
    tout = tout if isinstance(tout, tuple) else (tout,)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    sum(loss(o) for o in tout).backward()
    want = embed_net2_from_jax({"params": host(jgrad)})
    for name, p in tmod.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (name, err, np.abs(w).max())
    moved = embed_net2_from_jax({"batch_stats": host(new["batch_stats"])})
    for name, buf in tmod.named_buffers():
        np.testing.assert_allclose(buf.numpy(), moved[name].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=name)

    variables = {**variables, "batch_stats": host(new["batch_stats"])}
    jeval = jax.jit(lambda v, x: jmod.apply(v, x))(variables, jnp.asarray(x))
    jeval = jeval if isinstance(jeval, tuple) else (jeval,)
    with torch.no_grad():
        teval = tmod.eval()(torch.from_numpy(x))
    teval = teval if isinstance(teval, tuple) else (teval,)
    for a, b in zip(teval, jeval):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("kind,stride", [("basic", 1), ("basic", 2), ("bottleneck", 2),
                                         ("bottleneck", 1)])
def test_blocks(kind, stride):
    """A block with a downsample branch (stride 2, or stride 1 with a change
    of width as layer4 at stride 1 has): the stride on the 3x3."""
    x = np.random.default_rng(1).normal(size=(2, 8, 6, 16)).astype(np.float32)
    jcls, tcls = ((jr.BasicBlock, tr.BasicBlock) if kind == "basic"
                  else (jr.Bottleneck, tr.Bottleneck))
    feats = 8
    jmod = jcls(feats, strides=(stride, stride), downsample=True)
    variables = init(jmod, jnp.asarray(x))
    tmod = tcls(16, feats, stride, downsample=True)
    run_both(jmod, tmod, variables, x)


def test_stem_has_no_relu_after_bn1():
    x = np.random.default_rng(2).normal(size=(2, 64, 32, 3)).astype(np.float32)
    jmod = jr.ResNetStem("resnet18")
    run_both(jmod, tr.ResNetStem("resnet18"), init(jmod, jnp.asarray(x)), x)


def test_trunk_returns_layer3_and_layer4_with_last_stride_one():
    x = np.random.default_rng(3).normal(size=(2, 16, 8, 64)).astype(np.float32)
    jmod = jr.ResNetTrunk("resnet18")
    tmod = tr.ResNetTrunk("resnet18")
    run_both(jmod, tmod, init(jmod, jnp.asarray(x)), x)
    x3, x4 = tmod.eval()(torch.from_numpy(x))
    assert x3.shape == (2, 4, 2, 256) and x4.shape == (2, 4, 2, 512)
    assert tuple(tr.ResNetTrunk("resnet18", last_stride_1=False).eval()(
        torch.from_numpy(x))[1].shape) == (2, 2, 1, 512)


def test_flax_batch_norm_is_not_torchs():
    """The buffers move by the biased variance with momentum 0.99; torch's
    ``batch_norm`` would write the unbiased one with momentum 0.1."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 3, 2, 4)).astype(np.float32))
    bn = tr.BatchNorm(4).train()
    bn(x)
    flat = x.reshape(-1, 4)
    biased = flat.var(0, unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.99 + 0.01 * biased).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), (0.01 * flat.mean(0)).numpy(),
                               rtol=1e-5, atol=1e-8)


def _torchvision_state_dict(arch, seed):
    """A seeded state_dict in torchvision's layout (with the keys torchvision
    has and the port does not: ``num_batches_tracked``, ``fc``), wrapped in
    ``module.`` as a DDP checkpoint is."""
    g = np.random.default_rng(seed)
    stem, trunk = tr.ResNetStem(arch), tr.ResNetTrunk(arch, last_stride_1=False)
    sd = {}
    for module in (stem, trunk):
        for k, v in module.state_dict().items():
            sd[k] = torch.from_numpy(g.normal(scale=0.1, size=tuple(v.shape)).astype(np.float32))
            if k.endswith("running_var"):
                sd[k] = sd[k].abs() + 0.5
                sd[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    sd["fc.weight"] = torch.zeros(1000, tr.pool_dim(arch))
    sd["fc.bias"] = torch.zeros(1000)
    return {"module." + k: v for k, v in sd.items()}


def test_import_torchvision_resnet_fills_every_stem_and_the_trunk_as_the_jax_import_does():
    hw = (64, 32)
    jmod = JEmbedNet2(class_num=3, arch="resnet18")
    probe = jnp.zeros((1, *hw, 3))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xRGB=probe, xIR=probe,
                                              xZ=probe, modal=0, train=True))
    g = np.random.default_rng(5)
    variables = jax.tree_util.tree_map(
        lambda s: g.normal(size=s.shape).astype(np.float32), shapes)
    sd = _torchvision_state_dict("resnet18", 6)

    jout, jn = jr.import_torchvision_resnet(dict(variables), sd)
    model = EmbedNet2(class_num=3, arch="resnet18")
    model.load_state_dict(embed_net2_from_jax(variables))
    n = tr.import_torchvision_resnet(model, sd)
    assert n == jn
    want = embed_net2_from_jax(host(jout))
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=name)
    # the three stems got the same weights, the non-local blocks kept theirs
    got = model.state_dict()
    for stem in ("visible_module", "thermal_module", "gray_module"):
        assert torch.equal(got[f"{stem}.layer1.1.bn2.running_var"],
                           sd["module.layer1.1.bn2.running_var"])
    assert torch.equal(got["trunk.layer4.1.conv2.weight"], sd["module.layer4.1.conv2.weight"])
    assert torch.equal(got["trunk.NL2.0.W_conv.weight"],
                       embed_net2_from_jax(variables)["trunk.NL2.0.W_conv.weight"])


def test_import_refuses_a_wrong_arch_and_an_empty_match(tmp_path):
    model = tr.ResNetStem("resnet50")
    with pytest.raises(ValueError, match="shape mismatch"):
        tr.import_torchvision_resnet(model, _torchvision_state_dict("resnet18", 7))
    with pytest.raises(ValueError, match="nothing imported"):
        tr.import_torchvision_resnet(torch.nn.Linear(2, 2), _torchvision_state_dict("resnet18", 7))
    path = str(tmp_path / "r18.pt")
    torch.save({"state_dict": _torchvision_state_dict("resnet18", 8)}, path)
    assert tr.import_torchvision_resnet(tr.ResNetStem("resnet18"), path) > 0
