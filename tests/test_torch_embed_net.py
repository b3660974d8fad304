"""The port's ``models/embed_net.py`` against the JAX package's ``EmbedNet``
(resnet18 at 96x48, four images a modality): every modal (0 concatenates visible and
thermal) with ``gm_pool`` on (GeM) and off (average), in eval mode (``(l2(feat),
l2(feat_pool))``) and in train mode (``(feat_pool, logits)`` and the running
statistics after); ``with_feature=True`` in either mode (``(feat_pool, logits,
x4, mask, x3)``); the 6-part head (``part=True``) and the non-local trunk
(``no_local="on"``) in both modes; the variable trees name for name (no neck
or classifier with ``part``, no plain trunk with ``no_local``); and
``load_torchvision_weights``.

Weights are seeded numpy values carried across by ``embed_net_from_jax``.
Tolerance: the unit-length features of eval mode rtol 1e-4 / atol 1e-5.
Every other output (train mode, and the feature maps and logits of eval mode,
whose elements reach 10-30) is held within 1e-4 of its largest element and the running statistics within
1e-4 of theirs: batch norms over a few rows divide by ``E[x^2] - E[x]^2``,
which amplifies the rounding of fp32 sums taken in another order.  The part
head in train mode within 2e-4 (``PART_TRAIN_RTOL``, measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.models.embed_net import EmbedNet as JEmbedNet
from vqvae2_tpu_torch.models import resnet as tr
from vqvae2_tpu_torch.models.embed_net import EmbedNet
from vqvae2_tpu_torch.utils.jax_import import embed_net_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_RTOL = 1e-4
# the part head in train mode: six batch norms over four rows; the port's
# outputs lie 5.1e-5 of their largest element off a float64 forward of the
# port, the JAX package's 6.0e-5, so the two differ by up to 1.1e-4
PART_TRAIN_RTOL = 2e-4
HW = (96, 48)
CLASSES = 5

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
    """LeCun-scaled kernels (He-scaled ones grow the eval-mode activations of
    the non-local trunk past what the part head's tenth power holds in fp32), scales 1 +- 0.1 (the non-local blocks' output scale
    0.1 +- 0.01: flax starts it at 0), biases and means +- 0.1, variances in
    [0.5, 1.5]."""
    g = np.random.default_rng(seed)

    def fill(path, s):
        keys = [getattr(k, "key", str(k)) for k in path]
        leaf = keys[-1]
        if leaf == "var":
            return g.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            return g.normal(0, 0.1, s.shape).astype(np.float32)
        if leaf == "scale":
            base = 0.1 if "W_bn" in keys else 1.0
            return (base * (1 + g.normal(0, 0.1, s.shape))).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (g.normal(size=s.shape) * np.sqrt(1.0 / fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def images(seed):
    """Four images of different contrast and brightness: the neck's batch
    norm over the pooled features of a train batch then divides by variances
    well above its eps.  Images alike, or two of them, give variances near
    eps, which turn the rounding of the sums into 1e-3 of the logits on both
    sides (against a float64 forward of the port: 3e-4 for the port's, 2e-4
    for the JAX package's, at two images)."""
    g = np.random.default_rng(seed)
    scale = np.asarray([0.5, 1.0, 1.5, 2.0], np.float32)[:, None, None, None]
    shift = np.asarray([-0.5, -0.2, 0.2, 0.5], np.float32)[:, None, None, None]
    return (g.normal(size=(4, *HW, 3)) * scale + shift).astype(np.float32)


CONFIGS = {"plain": {}, "part": {"part": True}, "no_local": {"no_local": "on"}}


@pytest.fixture(scope="module")
def nets():
    """{config: (JAX module, seeded variables)}."""
    out = {}
    for i, (name, kw) in enumerate(sorted(CONFIGS.items())):
        jm = JEmbedNet(CLASSES, arch="resnet18", **kw)
        probe = jnp.zeros((1, *HW, 3))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xRGB=probe, modal=1,
                                                with_feature=True))
        out[name] = (jm, seeded(shapes, 10 + i))
    return out


def port_net(variables, train, **kw):
    model = EmbedNet(CLASSES, arch="resnet18", **kw)
    model.load_state_dict(embed_net_from_jax(variables))
    return model.train(train)


def inputs(modal):
    rgb, ir = images(1), images(2)
    return {0: dict(xRGB=rgb, xIR=ir), 1: dict(xRGB=rgb), 2: dict(xIR=ir), 3: dict(xZ=rgb)}[modal]


def run_both(jm, variables, train, modal, port_kw=None, **call):
    x = inputs(modal)
    model = port_net(variables, train, **(port_kw or {}))
    got = model(modal=modal, **{k: torch.from_numpy(v) for k, v in x.items()}, **call)
    want, upd = jm.apply(variables, modal=modal, train=train, mutable=["batch_stats"],
                         **{k: jnp.asarray(v) for k, v in x.items()}, **call)
    return model, got, want, upd


def flat(tree):
    return [np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)
            for t in jax.tree_util.tree_leaves(tree, is_leaf=lambda t: isinstance(t, torch.Tensor))]


def assert_outputs(got, want, train, rtol=TRAIN_RTOL):
    """Unit-length features at TOL; every other output (logits, feature maps
    of magnitude 10-30) within TRAIN_RTOL of its largest element."""
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(b).all()
        unit = a.ndim == 2 and np.allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-5)
        if unit and not train:
            np.testing.assert_allclose(a, b, **TOL)
        else:
            assert float(np.abs(a - b).max()) <= rtol * float(np.abs(b).max()), \
                float(np.abs(a - b).max())


def assert_statistics(model, variables, upd):
    want = embed_net_from_jax({"params": variables["params"], "batch_stats": host(upd)})
    for name, buf in model.named_buffers():
        w = want[name].numpy()
        assert float(np.abs(buf.numpy() - w).max()) <= TRAIN_RTOL * float(np.abs(w).max()), name


@pytest.mark.parametrize("gm_pool", ["on", "off"])
@pytest.mark.parametrize("modal", [0, 1, 2, 3])
def test_every_modal_and_pooling_in_both_modes(nets, modal, gm_pool):
    jm, variables = nets["plain"]
    jm = jm.clone(gm_pool=gm_pool)
    for train in (False, True):
        model, got, want, upd = run_both(jm, variables, train, modal,
                                         port_kw=dict(gm_pool=gm_pool))
        assert_outputs(got, want, train)
        if train:
            assert got[0].shape == (8 if modal == 0 else 4, 512)
            assert_statistics(model, variables, upd["batch_stats"])
        else:
            assert torch.allclose(torch.linalg.norm(got[0], dim=1), torch.ones(len(got[0])))


@pytest.mark.parametrize("train", [False, True])
def test_with_feature_returns_five_in_either_mode(nets, train):
    jm, variables = nets["plain"]
    _, got, want, _ = run_both(jm.clone(gm_pool="off"), variables, train, 1,
                               port_kw=dict(gm_pool="off"), with_feature=True)
    assert len(got) == 5
    feat_pool, logits, x4, mask, x3 = got
    assert logits.shape == (4, CLASSES) and mask.shape == (*x4.shape[:3], 1)
    assert x3.shape[1:3] == x4.shape[1:3]           # layer4 at stride 1
    assert_outputs(got, want, train)


@pytest.mark.parametrize("train", [False, True])
def test_part_head(nets, train):
    jm, variables = nets["part"]
    model, got, want, upd = run_both(jm, variables, train, 1, port_kw=dict(part=True))
    assert_outputs(got, want, train, PART_TRAIN_RTOL)
    if train:
        feats, logits, feat_all = got
        assert len(feats) == len(logits) == 6 and feat_all.shape == (4, 6 * 512)
        assert_statistics(model, variables, upd["batch_stats"])


@pytest.mark.parametrize("train", [False, True])
def test_non_local_trunk(nets, train):
    jm, variables = nets["no_local"]
    model, got, want, upd = run_both(jm, variables, train, 2, port_kw=dict(no_local="on"),
                                     with_feature=True)
    assert_outputs(got, want, train)
    if train:
        assert_statistics(model, variables, upd["batch_stats"])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_variables_match_name_for_name(nets, config):
    _, variables = nets[config]
    model = EmbedNet(CLASSES, arch="resnet18", **CONFIGS[config])
    mapped = embed_net_from_jax(variables)
    assert set(mapped) == set(model.state_dict())
    tops = {k.split(".")[0] for k in mapped}
    assert ("base_resnet" in tops) == (config != "no_local")
    assert ("nl_trunk" in tops) == (config == "no_local")
    assert ({"bottleneck", "classifier"} <= tops) == (config != "part")
    assert "bias" not in dict(model.bottleneck.named_parameters()) if config != "part" else True


def test_load_torchvision_weights_fills_every_stem(tmp_path):
    g = torch.Generator().manual_seed(3)
    donor = tr.ResNetStem("resnet18")
    trunk = tr.ResNetTrunk("resnet18")
    sd = {k: torch.randn(v.shape, generator=g) if v.is_floating_point() else v
          for k, v in {**donor.state_dict(), **trunk.state_dict()}.items()}
    path = str(tmp_path / "resnet18.pt")
    torch.save(sd, path)
    model = EmbedNet(CLASSES, arch="resnet18")
    assert tr.load_torchvision_weights(model, path) is model
    for stem in (model.visible_module, model.thermal_module, model.z_module):
        assert torch.equal(stem.conv1.weight, sd["conv1.weight"])
        assert torch.equal(stem.layer1[1].bn2.running_var, sd["layer1.1.bn2.running_var"])
    assert torch.equal(model.base_resnet.layer4[0].conv1.weight, sd["layer4.0.conv1.weight"])
